"""The pruning level step as a hand-written CUDA kernel (K1).

One level of Felsenstein pruning computes, for every internal node ``w`` of
the level and every site pattern ``p``, the product of the children's
transition-weighted messages:

    prod[w, p, i] = PROD_k  sum_j P[w, k, i, j] * clv[w, k, p, j]

It replaces the Pallas TPU kernel
``hyphy_tpu/ops/pallas_pruning.py:38`` (``_level_kernel``, reached there
through ``level_products`` -> ``_forward`` -> ``_call``).  The CUDA source is
``csrc/level_products.cu``.

What bounds it on an H100 SXM (67 TFLOP/s fp32 and 34 TFLOP/s fp64 outside
the tensor cores, 3.35 TB/s; NVIDIA's data sheet): each CLV element read
feeds 2*S FLOP, so at S = 61 the fp32 kernel is bound by bytes and
operations alike (0.228 ms each at (W,K,P,S) = (500,2,2048,61)) and the
fp64 kernel by bytes (0.456 ms, operations 0.450 ms).  Tensor cores would
only lower a roof that does not bind, and TF32 would break the fp32 path's
1e-5 accuracy; TMA cannot address the tiles (a 61-state CLV row is 244
bytes, not a multiple of 16, and tile starts are unaligned).

The design: one CUDA-core kernel template, register-tiled (a thread keeps
8 patterns x 8 states in fp32, 8 x 4 in fp64, of dot products and of
running products over the children, so that it reads 0.25 words of shared
memory per FMA in fp32), fed by a 2-stage ``cp.async`` ring of (P[w, k],
CLV tile) pairs.  Each pair is copied as the contiguous ranges it is in
global memory, by 16-byte chunks into shared memory shifted to the
source's alignment; the j loop runs exactly to S, so nothing is padded.
The state-group count SG (ceil(S / states per thread) rounded up to a
power of two) is a template constant, so the 4-state GTR levels run the
same kernel.  The grid is (pattern tiles, W): one block per tile of one
node, over all its children.  :func:`_launch_plan` chooses SG; the
pattern count per thread RP, the tile TP and the shared memory follow
from it and are passed as an echo, which the C entry point recomputes
and refuses when it disagrees.

The wrapper :func:`level_products` is a ``torch.autograd.Function``.  On a
CUDA tensor it launches the kernel (or raises: there is no fallback); on a
CPU tensor — and only there — it runs the plain version
:func:`level_products_reference`.  The backward is the VJP of the plain
version on either device, as the JAX package's custom VJP is
(``pallas_pruning.py:80-82``); it has no kernel of its own there either.
Under ``create_graph`` it is taken on the saved inputs with a graph, so a
Hessian through the pruning (``LikelihoodFunction.covariance_matrix``) is
the plain version's.
``level_products.launches`` counts kernel launches, under a lock, since
the blocks of a sharded per-site solve launch from threads of their own.
"""

from __future__ import annotations

import ctypes
import threading

import torch

from hyphy_tpu_torch.ops import cuda_build

_MAX_STATES = 64      # 16 state groups x 4 states (fp64), 8 x 8 (fp32)
_MAX_NODES = 65535    # grid.y
_THREADS = 256
_PATTERNS_PER_THREAD = 8
# states per thread, as csrc/level_products.cu instantiates the kernel
_STATES_PER_THREAD = {torch.float32: 8, torch.float64: 4}
# the blocks of a sharded per-site solve launch from threads of their own
_count_lock = threading.Lock()


def _launch_plan(w: int, k: int, p: int, s: int, dtype: torch.dtype):
    """(SG, RP, TP, smem_bytes) for one level launch.

    SG state groups of RS states (8 in fp32, 4 in fp64) cover S; each
    thread keeps RP = 8 patterns, so a tile holds TP = RP * 256 / SG
    patterns.  A ring stage holds P[w, k] and the CLV tile as the
    contiguous ranges they are in global memory, each with room for its
    alignment shift (< 16 bytes) and for the rows the kernel reads past S
    (RS * SG state rows), rounded to 16 bytes; two stages make the shared
    memory.  The launch has ceil(P / TP) x W blocks."""
    size = dtype.itemsize
    rs = _STATES_PER_THREAD[dtype]
    sg = 1
    while rs * sg < s:
        sg *= 2
    rp = _PATTERNS_PER_THREAD
    tp = rp * _THREADS // sg
    chunk = 16 // size

    def rounded(n):
        return -(-n // chunk) * chunk

    smem = 2 * (rounded(rs * sg * s + chunk) + rounded(tp * s + chunk)) * size
    return sg, rp, tp, smem


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
    w, k, p, s = cc.shape
    plan = _launch_plan(w, k, p, s, cc.dtype)
    out = torch.empty((w, p, s), dtype=cc.dtype, device=cc.device)
    lib = cuda_build.load("level_products")
    fn = lib.level_products_f32 if cc.dtype == torch.float32 else lib.level_products_f64
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 8 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    with torch.cuda.device(cc.device):
        stream = torch.cuda.current_stream(cc.device).cuda_stream
        err = fn(cc.data_ptr(), cp.data_ptr(), out.data_ptr(), w, k, p, s, *plan, stream)
    if err != 0:
        raise RuntimeError(f"level_products kernel launch failed: CUDA error {err}")
    with _count_lock:
        level_products.launches += 1
    return out


class _LevelProducts(torch.autograd.Function):
    @staticmethod
    def forward(ctx, cc, cp):
        # the kernel's limits hold on every device, so that a caller the CPU
        # runs meets them as the card would
        _check(cc, cp)
        ctx.save_for_backward(cc, cp)
        if cc.is_cuda:
            return _launch(cc, cp)
        return level_products_reference(cc, cp)

    @staticmethod
    def backward(ctx, grad):
        cc, cp = ctx.saved_tensors
        wanted = ctx.needs_input_grad
        if torch.is_grad_enabled():
            # under create_graph (a Hessian): the VJP of the plain version on
            # the saved inputs themselves, so that its graph reaches them and
            # the second derivative is the plain version's; detached copies
            # would give a VJP with no graph, and every second derivative
            # through the pruning would come out 0
            inputs = [x for x, need in zip((cc, cp), wanted) if need]
            got = iter(torch.autograd.grad(
                level_products_reference(cc, cp), inputs, grad, create_graph=True
            ))
            return tuple(next(got) if need else None for need in wanted)
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
