"""The pruning level step as a hand-written CUDA kernel (K1).

One level of Felsenstein pruning computes, for every internal node ``w`` of
the level and every site pattern ``p``, the product of the children's
transition-weighted messages:

    prod[w, p, i] = PROD_k  sum_j P[w, k, i, j] * clv[w, k, p, j]

It replaces the Pallas TPU kernel
``hyphy_tpu/ops/pallas_pruning.py::_level_kernel`` (reached there through
``level_products`` -> ``_forward`` -> ``_call``).  The CUDA source is
``csrc/level_products.cu``: a simple CUDA-core kernel (no tensor cores,
``wgmma`` or TMA yet) templated on float and double, with a grid over
(pattern tile, node), ``P[w, k]`` and the child's CLV tile staged in shared
memory one child at a time, and the product over children held in
registers.

What bounds it on an H100 SXM (the card reports itself as "NVIDIA H100
80GB HBM3", 700 W): one full 1000-taxon x 2048-pattern 61-state
evaluation of ``bench.py``'s tree sends 1,998 child messages through it,
i.e. 1,998 x 2 x 2048 x 61^2 = 30.5 GFLOP, and moves 1.53 GB in fp32
(3.05 GB in fp64: every child CLV and propagator read once, every parent
written once).  Against the card's peaks outside the tensor cores
(67 TFLOP/s fp32, 34 TFLOP/s fp64; NVIDIA's data sheet) and 3.35 TB/s,
that is 0.46 ms per evaluation in fp32 (operations and bytes about equal)
and 0.91 ms in fp64 (bytes).  The measured times are in PERF.md.

The wrapper :func:`level_products` is a ``torch.autograd.Function``.  On a
CUDA tensor it launches the kernel (or raises: there is no fallback); on a
CPU tensor — and only there — it runs the plain version
:func:`level_products_reference`.  The backward is the VJP of the plain
version on either device, as the JAX package's custom VJP is
(``pallas_pruning.py:80-82``); it has no kernel of its own there either.
``level_products.launches`` counts kernel launches.
"""

from __future__ import annotations

import ctypes

import torch

from hyphy_tpu_torch.ops import cuda_build

_MAX_STATES = 64      # the kernel's state lanes per block
_MAX_NODES = 65535    # grid.y


def level_products_reference(cc: torch.Tensor, cp: torch.Tensor) -> torch.Tensor:
    """Plain version: the einsum formulation of ``_einsum_impl``.
    ``cc`` [W, K, P, S], ``cp`` [W, K, S, S] -> [W, P, S]."""
    return torch.einsum("wkij,wkpj->wkpi", cp, cc).prod(dim=1)


def _check(cc: torch.Tensor, cp: torch.Tensor) -> None:
    if cc.dtype not in (torch.float32, torch.float64) or cp.dtype != cc.dtype:
        raise TypeError(f"level_products takes fp32 or fp64, got {cc.dtype}/{cp.dtype}")
    if cc.dim() != 4 or cp.dim() != 4:
        raise ValueError("level_products takes cc [W,K,P,S] and cp [W,K,S,S]")
    w, k, _, s = cc.shape
    if tuple(cp.shape) != (w, k, s, s):
        raise ValueError(f"shape mismatch: cc {tuple(cc.shape)}, cp {tuple(cp.shape)}")
    if not 1 <= s <= _MAX_STATES or k < 1 or w > _MAX_NODES:
        raise ValueError(f"unsupported level shape {tuple(cc.shape)}")
    if cp.device != cc.device:
        raise ValueError(f"cc on {cc.device}, cp on {cp.device}")
    if not (cc.is_contiguous() and cp.is_contiguous()):
        raise ValueError("level_products needs contiguous inputs")


def _launch(cc: torch.Tensor, cp: torch.Tensor) -> torch.Tensor:
    _check(cc, cp)
    w, k, p, s = cc.shape
    out = torch.empty((w, p, s), dtype=cc.dtype, device=cc.device)
    lib = cuda_build.load("level_products")
    fn = lib.level_products_f32 if cc.dtype == torch.float32 else lib.level_products_f64
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    with torch.cuda.device(cc.device):
        stream = torch.cuda.current_stream(cc.device).cuda_stream
        err = fn(cc.data_ptr(), cp.data_ptr(), out.data_ptr(), w, k, p, s, stream)
    if err != 0:
        raise RuntimeError(f"level_products kernel launch failed: CUDA error {err}")
    level_products.launches += 1
    return out


class _LevelProducts(torch.autograd.Function):
    @staticmethod
    def forward(ctx, cc, cp):
        ctx.save_for_backward(cc, cp)
        if cc.is_cuda:
            return _launch(cc, cp)
        return level_products_reference(cc, cp)

    @staticmethod
    def backward(ctx, grad):
        cc, cp = ctx.saved_tensors
        wanted = ctx.needs_input_grad
        with torch.enable_grad():
            cc_ = cc.detach().requires_grad_(wanted[0])
            cp_ = cp.detach().requires_grad_(wanted[1])
            inputs = [x for x, need in zip((cc_, cp_), wanted) if need]
            got = iter(torch.autograd.grad(
                level_products_reference(cc_, cp_), inputs, grad
            ))
        return tuple(next(got) if need else None for need in wanted)


def level_products(cc: torch.Tensor, cp: torch.Tensor) -> torch.Tensor:
    """[W, patterns, S] sibling-product messages for one level.

    ``cc``: [W, K, patterns, S] gathered child CLVs; ``cp``: [W, K, S, S]
    child transition matrices, both fp32 or both fp64, contiguous."""
    return _LevelProducts.apply(cc, cp)


level_products.launches = 0
