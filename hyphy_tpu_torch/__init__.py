"""hyphy_tpu_torch — the PyTorch/CUDA port of ``hyphy_tpu``.

A second package beside the JAX one, with the same module paths and class
and function names, so each module's counterpart is found by its path.  It
imports ``torch``, numpy and scipy, and nothing of ``jax`` or ``hyphy_tpu``:
the numpy-only modules it needs (``data/``, ``tree/``, ``utils/synth.py``,
``io/json_out.py``) are copies kept here.

The analyses are in ``methods/`` (FEL, SLAC, MEME, FUBAR, B-STILL, the
contrast methods, PRIME, the BUSTED family, RELAX, aBSREL, LEISR, FADE,
FitMultiModel, ``simulate``), each also a command of ``python -m
hyphy_tpu_torch`` (``cli.py``).  The one hand-written kernel is the pruning level step
(``ops/level_products.py`` over ``csrc/level_products.cu``); everything else
is plain PyTorch.  Entry points take ``device=None``, which resolves to
``settings.device`` (``"cuda"`` by default) and raises without a card.
"""

__version__ = "0.1.0"

from hyphy_tpu_torch.config import settings  # noqa: E402
from hyphy_tpu_torch.data.alignment import Alignment, read_alignment  # noqa: E402
from hyphy_tpu_torch.data.filter import DataFilter  # noqa: E402
from hyphy_tpu_torch.data.genetic_code import GeneticCode  # noqa: E402
from hyphy_tpu_torch.likelihood import LikelihoodFunction  # noqa: E402
from hyphy_tpu_torch.tree.topology import Tree  # noqa: E402

__all__ = [
    "Alignment",
    "DataFilter",
    "GeneticCode",
    "LikelihoodFunction",
    "Tree",
    "read_alignment",
    "settings",
]
