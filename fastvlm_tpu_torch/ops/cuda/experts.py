"""Kernel K5: the routed experts of a sparse decoder layer (Qwen2-MoE /
Qwen3-MoE / Mellum2 numerics): a softmax router over E experts, the top k
of each token with their weights renormalised to sum 1 (``norm_topk_prob``),
and each token's output the weighted sum of its k SwiGLU experts.

No TPU kernel stands behind it: the JAX package has no expert layer. Four
launches a layer whatever the number of experts, against 3 products x E
experts for a loop over experts:

  * ``moe_k5_route`` (Triton): a block of tokens' router logits (x @ W_r,
    f32 accumulation), softmax, top-k by repeated argmax (ties to the lower
    expert), the weights renormalised, and a counting sort of the (token,
    slot) pairs by expert: each pair takes its rank in its expert from an
    atomic count, and its pair index lands at ``sorted[e * N + rank]``;
  * ``moe_k5_gate_up``: one grouped launch over every expert's rows. It
    gathers its tokens' rows of x, multiplies by the expert's gate and up
    columns (f32 accumulation) and writes SiLU(gate) * up, rounded once, to
    the expert's rows of a compact (N * k, I) buffer; an expert that
    receives no token costs no tile;
  * ``moe_k5_down``: the compact rows times the expert's down product, each
    row scaled by its routing weight and written, rounded, at its pair's
    row of a (N * k, D) buffer;
  * ``moe_k5_combine`` (Triton): each token's k rows summed in f32 in slot
    order, rounded once.

The order within an expert comes from atomics and varies, but no row's
result depends on it: every sum runs in a fixed order, so the output is the
same bits on every call.

What bounds it on this card: at a prefill's thousands of tokens the
products, 2 x 3 x D x I x k operations a token (compute: Mellum2's burst of
27,200 tokens is 2.70 TFLOP, 2.73 ms at 989 TFLOP/s, two thirds of it
gate/up); at decode's few routed rows the experts' weights, 3 x D x I x 2
bytes each one touched (memory).

The two products have two routes, picked by the one shape the wrapper
sees without a read, the routed rows an expert gets on average, N k / E
(``grouped_route``):

  * at GROUPED_MIN_ROWS or more (a prefill): ``csrc/experts.cu``, CUDA C++
    for sm_90a, a persistent wgmma grouped GEMM a product. Two-block
    clusters, one block an SM, walk 128-row x 256-column output tiles that
    they derive on the device from the router's counts (``tile_walk`` is
    the walk's Python twin), with all column tiles of one row tile
    consecutive, so the blocks running at once share a few row tiles and
    each row tile's A operand (gathered rows of x, or h) comes from device
    memory about once; a cluster's two blocks take adjacent row tiles of
    one expert and share each weight tile by TMA multicast. A producer
    warpgroup gathers x's rows by cp.async and loads the weights by TMA
    into a ring of stages, two consumer warpgroups run wgmma, and the
    weights are read as stored (transposed-B operand). gate/up computes 128
    gate and 128 up columns a tile; down stores its rows through shared
    memory by bulk copies under the next tile's products. Needs D % 256 ==
    0, I % 128 == 0, E <= 256 (checked);
  * below it (decode steps, admission chunks): Triton products on a grid of
    (row tiles, column tiles), the tile height following the rows an
    expert gets (16 to 128). There the weights, not the products, bound
    the call (~1 row an expert at decode): a 128-row tile would be mostly
    padding, and the Triton route reads each touched expert once.

``experts_reference`` is the same function in plain PyTorch (a loop over
experts, each on the rows routed to it, products in f32): the CPU path and
the oracle the kernels are held against on the card. ``routed_experts``
routes by device: a CPU tensor takes the reference; a CUDA tensor launches
the kernels or raises. ``routed_experts.launches`` counts calls (four
kernels each), ``routed_experts.grouped`` those whose products took the
grouped route. ``counting(stats)`` adds, on the device and without a read,
each call's routed rows and its busiest expert's rows to ``stats`` (two
int64), for the scheduler's counters.
"""

from __future__ import annotations

import contextlib
import ctypes
import functools
import threading
from typing import List, Optional, Tuple

import torch
import torch.nn.functional as F

from fastvlm_tpu_torch.ops.cuda import _build

_LOCAL = threading.local()
_DTYPE_CODES = {torch.bfloat16: 1, torch.float16: 2}  # csrc/experts.cu's
GROUPED_BM = 128  # rows of a grouped-route tile (csrc/experts.cu's BM)
GROUPED_PAIR = 2  # blocks of a grouped-route cluster (csrc/experts.cu's PAIR)
# The average routed rows an expert from which a call takes the grouped
# route: one whole row tile. At Mellum2's widths the grouped route led at
# 128 rows an expert and trailed at 64 and 32 (PERF.md, section 6).
GROUPED_MIN_ROWS = 128


@contextlib.contextmanager
def counting(stats: Optional[torch.Tensor]):
    """Within the block, every call on this thread adds its routed rows to
    ``stats[0]`` and its busiest expert's rows to ``stats[1]`` (an int64
    (2,) tensor on the call's device); None counts nothing."""
    prev = getattr(_LOCAL, "stats", None)
    _LOCAL.stats = stats
    try:
        yield stats
    finally:
        _LOCAL.stats = prev


def _route(x, router_w, top_k: int, norm_topk: bool):
    """(ids (N, k) int64, weights (N, k) f32) of the router: softmax over
    f32 logits, the top k (ties to the lower index, as the kernel's
    argmax), renormalised."""
    probs = torch.softmax(x.float() @ router_w.float(), dim=-1)
    ids = torch.sort(probs, dim=-1, descending=True,
                     stable=True).indices[:, :top_k]
    wts = probs.gather(-1, ids)
    if norm_topk:
        wts = wts / wts.sum(-1, keepdim=True)
    return ids, wts


def experts_reference(x, router_w, gateup, down, top_k: int,
                      norm_topk: bool = True,
                      valid: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Plain version of the kernels. x: (N, D); router_w: (D, E); gateup:
    (E, D, 2I), each expert's gate columns then its up columns; down: (E,
    I, D); valid: (N,) bool, the tokens to route (others give zeros), or
    None for all. Returns (N, D) in x's dtype: each expert on the rows
    routed to it, SiLU(gate) * up in f32 rounded to x's dtype, the down
    product in f32 times the routing weight rounded to x's dtype, the k
    rows summed in f32 in slot order and rounded."""
    n, d = x.shape
    e, _, two_i = gateup.shape
    inter = two_i // 2
    ids, wts = _route(x, router_w, top_k, norm_topk)
    if valid is not None:
        ids = torch.where(valid[:, None], ids, torch.full_like(ids, -1))
    _count(ids, e)
    rows = torch.zeros((n, top_k, d), dtype=x.dtype, device=x.device)
    flat = ids.reshape(-1)
    for j in range(e):
        pairs = (flat == j).nonzero()[:, 0]
        if pairs.numel() == 0:
            continue
        tok = pairs // top_k
        gu = x[tok].float() @ gateup[j].float()
        h = (F.silu(gu[:, :inter]) * gu[:, inter:]).to(x.dtype)
        y = (h.float() @ down[j].float()) * wts.reshape(-1)[pairs, None]
        rows.view(n * top_k, d)[pairs] = y.to(x.dtype)
    out = torch.zeros((n, d), dtype=torch.float32, device=x.device)
    for s in range(top_k):
        out = out + rows[:, s].float()
    return out.to(x.dtype)


def _count(ids, e):
    """The plain version's share of ``counting``."""
    stats = getattr(_LOCAL, "stats", None)
    if stats is None:
        return
    flat = ids.reshape(-1)
    counts = torch.bincount(flat[flat >= 0], minlength=e)
    stats += torch.stack([counts.sum(), counts.max()]).to(stats.dtype)


def _check_cuda_args(x, router_w, gateup, down, top_k, valid,
                     grouped: bool):
    n, d = x.shape
    e = router_w.shape[1]
    if router_w.shape != (d, e) or gateup.dim() != 3 or \
            gateup.shape[:2] != (e, d) or gateup.shape[2] % 2:
        raise ValueError(f"routed_experts: x {tuple(x.shape)}, router "
                         f"{tuple(router_w.shape)}, gateup "
                         f"{tuple(gateup.shape)}: need (N, D), (D, E), "
                         f"(E, D, 2I)")
    inter = gateup.shape[2] // 2
    if down.shape != (e, inter, d):
        raise ValueError(f"routed_experts: down {tuple(down.shape)}, need "
                         f"{(e, inter, d)}")
    if e & (e - 1) or not 1 <= top_k <= e:
        raise ValueError(f"routed_experts: {e} experts (a power of two) "
                         f"top {top_k}")
    if x.dtype not in (torch.bfloat16, torch.float16):
        raise TypeError(f"routed_experts: unsupported dtype {x.dtype}")
    for name, t in (("router_w", router_w), ("gateup", gateup),
                    ("down", down)):
        if t.dtype != x.dtype or t.device != x.device:
            raise ValueError(f"routed_experts: {name} is {t.dtype} on "
                             f"{t.device}, expected {x.dtype} on {x.device}")
    if valid is not None and (valid.shape != (n,) or valid.device
                              != x.device):
        raise ValueError("routed_experts: valid must be (N,) on x's device")
    if grouped and (d % 256 or inter % GROUPED_BM or e > 256 or any(
            t.data_ptr() % 16 for t in (x, gateup, down))):
        raise ValueError(f"routed_experts: the grouped route needs D % 256 "
                         f"== 0, I % 128 == 0, at most 256 experts and "
                         f"16-byte aligned x, gateup and down; got D {d}, I "
                         f"{inter}, {e} experts")


def tile_rows(n: int, top_k: int, e: int) -> int:
    """The row tile of the Triton products for N tokens: the routed rows
    an expert gets on average, rounded up to 16, 64 or 128."""
    avg = n * top_k / e
    return 16 if avg <= 16 else 64 if avg <= 64 else 128


def grouped_route(n: int, top_k: int, e: int) -> bool:
    """Whether N tokens' products take the grouped route: the routed rows
    an expert gets on average, N k / E, at least GROUPED_MIN_ROWS."""
    return n * top_k >= GROUPED_MIN_ROWS * e


def tile_walk(counts, col_tiles: int,
              clusters: int) -> List[List[Tuple[int, int, int, int, int]]]:
    """The grouped route's tiles, block by block (blockIdx order), as
    csrc/experts.cu's ``build_tables`` and ``walk_tile`` derive them from the
    router's counts. Each expert has ceil(count / GROUPED_BM) row tiles,
    taken in pairs (ceil of half; none for an expert with no rows),
    experts in order; a cluster's tile q is column tile q % col_tiles of
    pair q // col_tiles, cluster c takes q = c, c + clusters, ..., and its
    block of rank r the r-th row tile of each pair. A tile is (expert, its first row
    in the expert, the expert's rows, the expert's first compact row,
    column tile); first row >= rows: the empty second tile of an expert's
    odd last pair, which its block walks without writing."""
    bm, pair = GROUPED_BM, GROUPED_PAIR
    pair0, row0 = [0], [0]
    for c in counts:
        pair0.append(pair0[-1] + triton_cdiv(triton_cdiv(int(c), bm), pair))
        row0.append(row0[-1] + int(c))
    total = pair0[-1] * col_tiles
    blocks = []
    for c in range(clusters):
        for rank in range(pair):
            e, mine = 0, []
            for q in range(c, total, clusters):
                pr = q // col_tiles
                while pair0[e + 1] <= pr:
                    e += 1
                mine.append((e, (pair * (pr - pair0[e]) + rank) * bm,
                             row0[e + 1] - row0[e], row0[e], q % col_tiles))
            blocks.append(mine)
    return blocks


def routed_experts(x: torch.Tensor, router_w: torch.Tensor,
                   gateup: torch.Tensor, down: torch.Tensor, top_k: int,
                   norm_topk: bool = True,
                   valid: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Routed experts over x (N, D); arguments as ``experts_reference``'s.
    Returns (N, D) in x's dtype. On a CUDA device four launches on the
    current stream (and a fill of the E counts), unsynchronised."""
    if x.device.type == "cpu":
        return experts_reference(x, router_w, gateup, down, top_k, norm_topk,
                                 valid)
    if x.device.type != "cuda":
        raise ValueError(f"routed_experts: no kernel for device {x.device}")
    if x.shape[0] == 0:
        return torch.empty_like(x)
    x, router_w = x.contiguous(), router_w.contiguous()
    gateup, down = gateup.contiguous(), down.contiguous()
    grouped = grouped_route(x.shape[0], top_k, router_w.shape[1])
    _check_cuda_args(x, router_w, gateup, down, top_k, valid, grouped)
    out = launch(x, router_w, gateup, down, top_k, norm_topk, valid,
                 grouped)[0]
    routed_experts.launches += 1
    routed_experts.grouped += grouped
    return out


routed_experts.launches = 0
routed_experts.grouped = 0


def launch(x, router_w, gateup, down, top_k: int, norm_topk: bool = True,
           valid: Optional[torch.Tensor] = None,
           grouped: Optional[bool] = None):
    """The four launches of ``routed_experts`` on checked CUDA arguments
    (``grouped``: the products' route, None for ``grouped_route``'s):
    (out (N, D), each (token, slot)'s expert (N * k,) int32, -1 where not
    routed, and its weight (N * k,) f32)."""
    x, router_w = x.contiguous(), router_w.contiguous()
    gateup, down = gateup.contiguous(), down.contiguous()
    route, gate_up, down_k, combine = _kernels()
    n, d = x.shape
    e = router_w.shape[1]
    inter = gateup.shape[2] // 2
    dev = x.device
    out = torch.empty_like(x)
    counts = torch.zeros((e,), dtype=torch.int32, device=dev)
    ids = torch.empty((n * top_k,), dtype=torch.int32, device=dev)
    wts = torch.empty((n * top_k,), dtype=torch.float32, device=dev)
    order = torch.empty((e * n,), dtype=torch.int32, device=dev)
    stats = getattr(_LOCAL, "stats", None)
    bt = 32
    route[(triton_cdiv(n, bt),)](
        x, router_w, counts if valid is None else valid.view(torch.int8),
        counts, ids, wts, order, n, d, E=e, K=top_k, BT=bt, BD=64, NORM=norm_topk,
        HAS_VALID=valid is not None, num_warps=4)
    h = torch.empty((n * top_k, inter), dtype=x.dtype, device=dev)
    y = torch.empty((n * top_k, d), dtype=x.dtype, device=dev)
    if grouped_route(n, top_k, e) if grouped is None else grouped:
        lib = _load()
        err = lib.fvlm_moe_k5_grouped(
            x.data_ptr(), gateup.data_ptr(), down.data_ptr(),
            counts.data_ptr(), order.data_ptr(), wts.data_ptr(), h.data_ptr(),
            y.data_ptr(), None if stats is None else stats.data_ptr(), n, d,
            inter, e, top_k, _DTYPE_CODES[x.dtype],
            torch.cuda.current_stream(dev).cuda_stream)
        _build.check(lib, err, "routed_experts")
    else:
        bm = tile_rows(n, top_k, e)
        m_tiles = triton_cdiv(n * top_k, bm) + e
        warps, stages = (8, 3) if bm == 128 else (4, 4)
        bn = 128 if inter % 128 == 0 else 64
        gate_up[(m_tiles, triton_cdiv(inter, bn))](
            x, gateup, counts, order, h,
            stats if stats is not None else counts, n, d, inter, E=e,
            K=top_k, BM=bm, BN=bn, BK=64, HAS_STATS=stats is not None,
            num_warps=warps, num_stages=stages)
        down_k[(m_tiles, triton_cdiv(d, 128))](
            h, down, counts, order, wts, y, n, d, inter, E=e, K=top_k,
            BM=bm, BN=128, BK=64, num_warps=warps, num_stages=stages)
    combine[(n, triton_cdiv(d, 512))](y, ids, out, d, K=top_k, BH=512,
                                      num_warps=4)
    return out, ids, wts


def triton_cdiv(a: int, b: int) -> int:
    return -(-a // b)


@functools.cache
def _load():
    lib = _build.load("experts")
    lib.fvlm_moe_k5_grouped.argtypes = (
        [ctypes.c_void_p] * 9 + [ctypes.c_int] * 6 + [ctypes.c_void_p])
    lib.fvlm_moe_k5_grouped.restype = ctypes.c_int
    return lib


@functools.cache
def _kernels():
    """The Triton kernels, defined (and so compiled) at first use.
    Triton resolves a kernel's names in its module's globals, not in this
    function's scope, so ``triton``, ``tl`` and the shared ``_k5_tile``
    are bound there, here."""
    global triton, tl, _k5_tile
    import triton
    import triton.language as tl

    @triton.jit
    def moe_k5_route(x_ptr, w_ptr, valid_ptr, counts_ptr, ids_ptr, wts_ptr,
                     order_ptr, N, D, E: tl.constexpr, K: tl.constexpr,
                     BT: tl.constexpr, BD: tl.constexpr, NORM: tl.constexpr,
                     HAS_VALID: tl.constexpr):
        rows = tl.program_id(0) * BT + tl.arange(0, BT)
        live = rows < N
        cols = tl.arange(0, E)
        logits = tl.zeros((BT, E), dtype=tl.float32)
        for d0 in range(0, D, BD):
            ds = d0 + tl.arange(0, BD)
            xt = tl.load(x_ptr + rows[:, None] * D + ds[None, :],
                         mask=live[:, None] & (ds[None, :] < D), other=0.0)
            wt = tl.load(w_ptr + ds[:, None] * E + cols[None, :],
                         mask=ds[:, None] < D, other=0.0)
            logits += tl.dot(xt, wt)
        mx = tl.max(logits, 1)
        p = tl.exp(logits - mx[:, None])
        p = p / tl.sum(p, 1)[:, None]
        if HAS_VALID:
            live = live & (tl.load(valid_ptr + rows, mask=live, other=0) != 0)
        # the top k: first their sum, then each in turn
        work = p
        total = tl.zeros((BT,), dtype=tl.float32)
        for _ in tl.static_range(K):
            top = tl.max(work, 1)
            at = tl.argmax(work, 1)
            total += top
            work = tl.where(cols[None, :] == at[:, None], -1.0, work)
        work = p
        for j in tl.static_range(K):
            top = tl.max(work, 1)
            at = tl.argmax(work, 1)
            work = tl.where(cols[None, :] == at[:, None], -1.0, work)
            if NORM:
                top = top / total
            pair = rows * K + j
            tl.store(ids_ptr + pair, tl.where(live, at, -1), mask=rows < N)
            tl.store(wts_ptr + pair, top, mask=rows < N)
            rank = tl.atomic_add(counts_ptr + at, 1, mask=live)
            tl.store(order_ptr + at * N + rank, pair, mask=live)

    @triton.jit
    def _k5_tile(counts_ptr, N, E: tl.constexpr, BM: tl.constexpr):
        """(expert, first row in it, its rows, its first compact row, live)
        of this program's row tile."""
        pid = tl.program_id(0)
        ex = tl.arange(0, E)
        cnt = tl.load(counts_ptr + ex)
        tiles = (cnt + BM - 1) // BM
        ends = tl.cumsum(tiles, 0)
        e = tl.sum((ends <= pid).to(tl.int32), 0)
        here = ex == e
        first = tl.sum(tl.where(here, ends - tiles, 0), 0)
        rows_e = tl.sum(tl.where(here, cnt, 0), 0)
        start = tl.sum(tl.where(ex < e, cnt, 0), 0)
        return e, (pid - first) * BM, rows_e, start, pid < tl.sum(tiles, 0)

    @triton.jit
    def moe_k5_gate_up(x_ptr, w_ptr, counts_ptr, order_ptr, h_ptr, stats_ptr,
                       N, D, I, E: tl.constexpr, K: tl.constexpr,
                       BM: tl.constexpr, BN: tl.constexpr, BK: tl.constexpr,
                       HAS_STATS: tl.constexpr):
        if HAS_STATS:
            if (tl.program_id(0) == 0) & (tl.program_id(1) == 0):
                cnt = tl.load(counts_ptr + tl.arange(0, E)).to(tl.int64)
                tl.atomic_add(stats_ptr, tl.sum(cnt, 0))
                tl.atomic_add(stats_ptr + 1, tl.max(cnt, 0))
        e, m0, rows_e, start, live = _k5_tile(counts_ptr, N, E, BM)
        if live:
            rows = m0 + tl.arange(0, BM)
            ok = rows < rows_e
            pair = tl.load(order_ptr + e * N + rows, mask=ok, other=0)
            tok = (pair // K).to(tl.int64)
            cols = tl.program_id(1) * BN + tl.arange(0, BN)
            cok = cols < I
            w = w_ptr + e.to(tl.int64) * D * (2 * I)
            g = tl.zeros((BM, BN), dtype=tl.float32)
            u = tl.zeros((BM, BN), dtype=tl.float32)
            for k0 in range(0, D, BK):
                ks = k0 + tl.arange(0, BK)
                kok = ks < D
                a = tl.load(x_ptr + tok[:, None] * D + ks[None, :],
                            mask=ok[:, None] & kok[None, :], other=0.0)
                wg = tl.load(w + ks[:, None] * (2 * I) + cols[None, :],
                             mask=kok[:, None] & cok[None, :], other=0.0)
                wu = tl.load(w + ks[:, None] * (2 * I) + I + cols[None, :],
                             mask=kok[:, None] & cok[None, :], other=0.0)
                g += tl.dot(a, wg)
                u += tl.dot(a, wu)
            hv = g / (1.0 + tl.exp(-g)) * u
            dst = h_ptr + (start + rows).to(tl.int64)[:, None] * I \
                + cols[None, :]
            tl.store(dst, hv.to(h_ptr.dtype.element_ty),
                     mask=ok[:, None] & cok[None, :])

    @triton.jit
    def moe_k5_down(h_ptr, w_ptr, counts_ptr, order_ptr, wts_ptr, y_ptr, N, D,
                    I, E: tl.constexpr, K: tl.constexpr, BM: tl.constexpr,
                    BN: tl.constexpr, BK: tl.constexpr):
        e, m0, rows_e, start, live = _k5_tile(counts_ptr, N, E, BM)
        if live:
            rows = m0 + tl.arange(0, BM)
            ok = rows < rows_e
            pair = tl.load(order_ptr + e * N + rows, mask=ok, other=0)
            cols = tl.program_id(1) * BN + tl.arange(0, BN)
            cok = cols < D
            w = w_ptr + e.to(tl.int64) * I * D
            src = h_ptr + (start + rows).to(tl.int64)[:, None] * I
            acc = tl.zeros((BM, BN), dtype=tl.float32)
            for k0 in range(0, I, BK):
                ks = k0 + tl.arange(0, BK)
                kok = ks < I
                a = tl.load(src + ks[None, :], mask=ok[:, None] & kok[None, :],
                            other=0.0)
                b = tl.load(w + ks[:, None] * D + cols[None, :],
                            mask=kok[:, None] & cok[None, :], other=0.0)
                acc += tl.dot(a, b)
            wt = tl.load(wts_ptr + pair, mask=ok, other=0.0)
            acc = acc * wt[:, None]
            dst = y_ptr + pair.to(tl.int64)[:, None] * D + cols[None, :]
            tl.store(dst, acc.to(y_ptr.dtype.element_ty),
                     mask=ok[:, None] & cok[None, :])

    @triton.jit
    def moe_k5_combine(y_ptr, ids_ptr, out_ptr, D, K: tl.constexpr,
                       BH: tl.constexpr):
        tok = tl.program_id(0).to(tl.int64)
        cols = tl.program_id(1) * BH + tl.arange(0, BH)
        cok = cols < D
        acc = tl.zeros((BH,), dtype=tl.float32)
        for j in tl.static_range(K):
            routed = tl.load(ids_ptr + tok * K + j) >= 0
            v = tl.load(y_ptr + (tok * K + j) * D + cols, mask=cok & routed,
                        other=0.0)
            acc += v.to(tl.float32)
        tl.store(out_ptr + tok * D + cols, acc.to(out_ptr.dtype.element_ty),
                 mask=cok)

    return moe_k5_route, moe_k5_gate_up, moe_k5_down, moe_k5_combine
