"""Newick parsing with HyPhy extensions.

Accepts the reference dialect (``src/core/topology.cpp:292``
``MainTreeConstructor``): branch lengths, quoted names, ``{MODEL}`` branch
annotations, comments in ``[...]``, and multifurcations.  Unnamed internal
nodes are named ``Node<k>`` where ``k`` is the node's preorder index
counting EVERY node including leaves (root = 0) — verified against the
reference binary's JSON branch names on CD2.nex (Node1/2/3/8/9/12).
"""

from __future__ import annotations

from typing import List, Optional


class ParseNode:
    __slots__ = ("name", "children", "length", "label", "parent")

    def __init__(self):
        self.name: str = ""
        self.children: List["ParseNode"] = []
        self.length: Optional[float] = None
        self.label: Optional[str] = None
        self.parent: Optional["ParseNode"] = None

    @property
    def is_leaf(self) -> bool:
        return not self.children


def parse_newick(text: str, internal_prefix: str = "Node") -> ParseNode:
    s = text.strip()
    if s.endswith(";"):
        s = s[:-1]
    pos = 0
    n = len(s)

    def skip_ws():
        nonlocal pos
        while pos < n:
            if s[pos] in " \t\r\n":
                pos += 1
            elif s[pos] == "[":  # comment
                depth = 1
                pos += 1
                while pos < n and depth:
                    if s[pos] == "[":
                        depth += 1
                    elif s[pos] == "]":
                        depth -= 1
                    pos += 1
            else:
                return

    def read_name() -> str:
        nonlocal pos
        skip_ws()
        if pos < n and s[pos] in "'\"":
            quote = s[pos]
            pos += 1
            start = pos
            while pos < n and s[pos] != quote:
                pos += 1
            name = s[start:pos]
            pos += 1  # closing quote
            return name
        start = pos
        while pos < n and s[pos] not in "(),:;{}[ \t\r\n":
            pos += 1
        return s[start:pos]

    def read_annotations(node: ParseNode):
        """Optional {label} and :length, in either order."""
        nonlocal pos
        while True:
            skip_ws()
            if pos < n and s[pos] == "{":
                end = s.index("}", pos)
                node.label = s[pos + 1 : end]
                pos = end + 1
            elif pos < n and s[pos] == ":":
                pos += 1
                skip_ws()
                start = pos
                while pos < n and (s[pos] in "+-.eE0123456789"):
                    pos += 1
                node.length = float(s[start:pos])
            else:
                return

    def subtree() -> ParseNode:
        nonlocal pos
        skip_ws()
        node = ParseNode()
        if pos < n and s[pos] == "(":
            pos += 1
            while True:
                child = subtree()
                child.parent = node
                node.children.append(child)
                skip_ws()
                if pos < n and s[pos] == ",":
                    pos += 1
                    continue
                if pos < n and s[pos] == ")":
                    pos += 1
                    break
                raise ValueError(f"newick parse error at {pos}: {s[max(0,pos-20):pos+20]!r}")
            node.name = read_name()
        else:
            node.name = read_name()
            if not node.name:
                raise ValueError(f"empty leaf name at {pos}")
        read_annotations(node)
        return node

    root = subtree()
    skip_ws()
    if pos < n:
        raise ValueError(f"trailing characters in newick at {pos}: {s[pos:pos+30]!r}")

    # name unnamed internal nodes by preorder index over ALL nodes
    # (reference numbering; root = 0)
    counter = 0

    def assign(nd: ParseNode):
        nonlocal counter
        if not nd.is_leaf and not nd.name:
            nd.name = f"{internal_prefix}{counter}"
        counter += 1
        for c in nd.children:
            assign(c)

    assign(root)
    return root
