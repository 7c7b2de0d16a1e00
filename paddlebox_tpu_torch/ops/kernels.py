"""The training step's four Hopper kernels, their plain versions, and
the push-engine resolver — the port of ``ops/pallas_kernels.py``'s
``gather_pool``, ``scatter_accumulate``, ``binned_merge_acc`` and
``merge_update``.

Each kernel is CUDA C++ for ``sm_90a`` under ``csrc/``, compiled with
nvcc into its own shared library with a plain C interface at first use
(into ``_build/``, keyed on a hash of the sources) and called through
ctypes on PyTorch's current stream. Each wrapper

- runs the kernel's plain PyTorch version when its tensors lie on the
  CPU, and only then;
- on CUDA tensors checks device, dtype, shape and contiguity, launches
  the kernel, raises if the launch reports an error, and adds one to its
  ``launches`` count (a plain int on the wrapper function).

Push engines (the JAX package's names, so a forced ``flags.push_engine``
means the same thing in both packages):

- ``scatter_accumulate`` — the kernel: premerged unique lanes gather
  exactly their rows, update, and write back once;
- ``binned_kernel`` — ``binned_push``: the ``binned_merge_acc`` kernel
  builds the per-row accumulator from the token stream (grouped by table
  super-block on the host plan, or on the device without one), then the
  ``merge_update`` kernel applies the optimizer to the touched rows;
- ``xla_scatter`` — ``index_add_`` of the token payload into a full
  (n_rows, grad_width + 3) accumulator (``binned_merge_acc_plain``),
  then ``merge_update`` (the JAX package's non-Pallas engine, kept under
  its name).
"""

from __future__ import annotations

import ctypes
import os
import shutil
import threading

import numpy as np
import torch

from paddlebox_tpu_torch.config import flags
from paddlebox_tpu_torch.embedding.config import EmbeddingConfig
from paddlebox_tpu_torch.embedding.optim import apply_updates
from paddlebox_tpu_torch.native import build as build_lib

CSRC_DIR = os.path.join(build_lib.PKG_DIR, "csrc")
KERNEL_SOURCES = {"gather_pool": "gather_pool.cu",
                  "scatter_accumulate": "scatter_accumulate.cu",
                  "binned_merge_acc": "binned_merge_acc.cu",
                  "merge_update": "merge_update.cu"}
KERNEL_HEADERS = ("apply_updates.cuh",)
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "--fmad=false", "-Xptxas", "-v", "-shared",
              "-Xcompiler", "-fPIC")
# row-width cap of scatter_accumulate and merge_update (16 columns per
# lane of a 32-lane group, csrc/apply_updates.cuh)
SA_MAX_WIDTH = 512
# columns gather_pool pools in one pass of a 32-lane group (16 a lane);
# wider rows go in chunks of this many columns
GP_CHUNK = 512
# shared memory a binned_merge_acc block may hold its (SB, P) accumulator
# in: 2048 rows at the dim-8 headline's P = 12
BINNED_SMEM_BYTES = 96 * 1024

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}
# nvcc's output per kernel from the build in this process (ptxas -v:
# registers, shared memory, spills)
build_logs: dict[str, str] = {}


# ---------------------------------------------------------------------------
# build + bind
# ---------------------------------------------------------------------------

def nvcc_path() -> str:
    path = (os.environ.get("NVCC") or shutil.which("nvcc")
            or "/usr/local/cuda/bin/nvcc")
    if not os.path.exists(path):
        raise build_lib.BuildError(
            "nvcc not found (set NVCC or put the CUDA toolkit on PATH)")
    return path


def _configure(name: str, lib: ctypes.CDLL) -> None:
    c = ctypes
    p, i32, i64, f32 = c.c_void_p, c.c_int32, c.c_int64, c.c_float
    if name == "gather_pool":
        fn = lib.pbt_gather_pool
        fn.argtypes = [p, i64, i32, p, i32, i32, i32, i32, p, i32, f32, f32,
                       f32, i32, i32, i32, i32, p, p]
    elif name == "scatter_accumulate":
        fn = lib.pbt_scatter_accumulate
        fn.argtypes = [p, i64, i32, p, p, p, i64, p, i64, p, i64, i64, i32,
                       i32, i32, c.POINTER(RowLayout), p]
    elif name == "binned_merge_acc":
        fn = lib.pbt_binned_merge_acc
        fn.argtypes = [p, p, i64, p, i64, p, i64, p, p, p, i64, i32, i32, p,
                       p]
    else:
        fn = lib.pbt_merge_update
        fn.argtypes = [p, i64, i32, p, i32, i32, i32, i32,
                       c.POINTER(RowLayout), p]
    fn.restype = c.c_int
    err = getattr(lib, f"pbt_{name}_error")
    err.argtypes = [c.c_int]
    err.restype = c.c_char_p


def build_kernels() -> dict[str, str]:
    """Build and load every kernel library not yet loaded: one nvcc per
    source, all started together. Returns {kernel: library path}."""
    with _lock:
        missing = [k for k in KERNEL_SOURCES if k not in _libs]
        if missing:
            cmd = [nvcc_path(), *NVCC_FLAGS]
            headers = [os.path.join(CSRC_DIR, h) for h in KERNEL_HEADERS]
            pending = {
                k: build_lib.start_build(
                    f"lib{k}", [os.path.join(CSRC_DIR, KERNEL_SOURCES[k])],
                    headers, cmd)
                for k in missing}
            for k, (path, proc) in pending.items():
                path, log = build_lib.finish_build(path, proc)
                lib = ctypes.CDLL(path)
                _configure(k, lib)
                _libs[k] = lib
                build_logs[k] = log
        return {k: lib._name for k, lib in _libs.items()}


def _lib(name: str) -> ctypes.CDLL:
    if name not in _libs:
        build_kernels()
    return _libs[name]


def _check_launch(name: str, code: int) -> None:
    if code != 0:
        msg = getattr(_libs[name], f"pbt_{name}_error")(code)
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {code} "
                           f"({msg.decode() if msg else '?'})")


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def _require(cond: bool, what: str) -> None:
    if not cond:
        raise ValueError(what)


def _require_cuda(name: str, device: torch.device,
                  **tensors: torch.Tensor) -> None:
    if device.type != "cuda":
        raise ValueError(f"{name}: tensors must lie on the CPU (plain "
                         f"version) or on a CUDA device, got {device}")
    for k, t in tensors.items():
        _require(t.device == device,
                 f"{name}: {k} is on {t.device}, expected {device}")


# ---------------------------------------------------------------------------
# gather_pool
# ---------------------------------------------------------------------------

def slot_thresholds(threshold, num_slots: int,
                     device: torch.device) -> torch.Tensor:
    """(S,) f32 thresholds on ``device``. A scalar is filled on the
    device: copying it from the host would synchronize the stream on
    every pull."""
    if isinstance(threshold, torch.Tensor):
        thr = threshold.to(device=device, dtype=torch.float32)
    elif np.ndim(threshold) == 0:
        thr = torch.full((num_slots,), float(threshold),
                         dtype=torch.float32, device=device)
    else:
        thr = torch.as_tensor(np.asarray(threshold, np.float32),
                              device=device)
    if thr.ndim == 0:
        thr = thr.expand(num_slots)
    _require(thr.shape == (num_slots,),
             f"threshold must be a scalar or ({num_slots},)")
    return thr.contiguous()


def gp_lane_group(pull_width: int) -> tuple[int, int]:
    """(G, CPL): the lanes gather_pool gives one (example, slot) output
    row and the columns each of them holds, for ``pull_width`` pooled
    columns — 8 lanes up to 64 columns (a warp pools four outputs), 16 up
    to 128, 32 beyond, each lane with CPL = ceil(min(P, GP_CHUNK) / G)
    columns, so the column loop stops at P. Rows wider than GP_CHUNK go
    in chunks of G * CPL = GP_CHUNK columns."""
    p = int(pull_width)
    if p < 1:
        raise ValueError(f"pull width {p} < 1")
    w = min(p, GP_CHUNK)
    g = 8 if w <= 64 else (16 if w <= 128 else 32)
    return g, -(-w // g)


def gather_pool_plain(table: torch.Tensor, idx: torch.Tensor,
                      cfg: EmbeddingConfig, num_slots: int, slot_len: int,
                      *, need_filter: bool = False, show_coeff: float = 0.2,
                      clk_coeff: float = 1.0, threshold=0.96,
                      embed_threshold: float = 0.0, quant_ratio: int = 0,
                      cvm_offset: int = 2) -> torch.Tensor:
    """Plain PyTorch statement of the gather_pool kernel (same per-token
    filters, same l = 0..L-1 summation order)."""
    B, T = idx.shape
    S, L = num_slots, slot_len
    n_rows = table.shape[0]
    P = cfg.pull_width
    rows = table.index_select(
        0, idx.reshape(-1).long().clamp(0, n_rows - 1))[:, :P]
    rows = rows.reshape(B, S, L, P)
    thr = slot_thresholds(threshold, S, table.device)[None, :, None]
    q_cols = torch.arange(P, device=table.device) >= cvm_offset + 1
    acc = None
    for l in range(L):
        x = rows[:, :, l]
        keep = None
        if need_filter:
            show, clk = x[..., 0:1], x[..., 1:2]
            keep = (show - clk) * show_coeff + clk * clk_coeff >= thr
        if embed_threshold > 0.0:
            show, w = x[..., 0:1], x[..., cvm_offset:cvm_offset + 1]
            drop = (show > embed_threshold) & (torch.abs(w) < embed_threshold)
            keep = ~drop if keep is None else keep & ~drop
        if quant_ratio > 0:
            q = torch.round(x * quant_ratio) / quant_ratio
            x = torch.where(q_cols, q, x)
        if keep is not None:
            x = x * keep.to(x.dtype)
        acc = x if acc is None else acc + x
    return acc.contiguous()


def gather_pool(table: torch.Tensor, idx: torch.Tensor,
                cfg: EmbeddingConfig, num_slots: int, slot_len: int, *,
                need_filter: bool = False, show_coeff: float = 0.2,
                clk_coeff: float = 1.0, threshold=0.96,
                embed_threshold: float = 0.0, quant_ratio: int = 0,
                cvm_offset: int = 2) -> torch.Tensor:
    """Fused gather + per-(example, slot) sum pool over the device table.

    table : (n_rows, W) f32, W >= cfg.pull_width; row NULL_INDEX (0) is
            the all-zero row masked tokens point at
    idx   : (B, S*L) int32 translated ids, slot-major (token (b, s, l) at
            column s*L + l)
    threshold may be a scalar or a per-slot (S,) vector. Returns
    (B, S, pull_width); the CVM transform applies downstream
    (seqpool_cvm.PooledSlots)."""
    B, T = idx.shape
    S, L = int(num_slots), int(slot_len)
    _require(T == S * L, f"idx has {T} columns, expected S*L = {S * L}")
    _require(table.ndim == 2 and table.dtype == torch.float32,
             "table must be a 2-D float32 tensor")
    n_rows, W = table.shape
    P = cfg.pull_width
    _require(P <= W, f"table width {W} < pull_width {P}")
    kw = dict(need_filter=need_filter, show_coeff=show_coeff,
              clk_coeff=clk_coeff, threshold=threshold,
              embed_threshold=embed_threshold, quant_ratio=quant_ratio,
              cvm_offset=cvm_offset)
    if table.device.type == "cpu" and idx.device.type == "cpu":
        return gather_pool_plain(table, idx, cfg, S, L, **kw)
    _require_cuda("gather_pool", table.device, idx=idx)
    _require(idx.dtype == torch.int32 and idx.is_contiguous(),
             "idx must be contiguous int32")
    _require(table.is_contiguous(), "table must be contiguous")
    _require(0 <= cvm_offset < W, "cvm_offset out of range")
    # the kernel reads the thresholds only under need_filter: without it,
    # no (S,) tensor is made (a fill kernel on every pull)
    thr = (slot_thresholds(threshold, S, table.device) if need_filter
           else None)
    out = torch.empty((B, S, P), dtype=torch.float32, device=table.device)
    if B * S == 0 or P == 0:
        return out
    lib = _lib("gather_pool")
    group, cols = gp_lane_group(P)
    with torch.cuda.device(table.device):
        code = lib.pbt_gather_pool(
            table.data_ptr(), n_rows, W, idx.data_ptr(), B, S, L, P,
            None if thr is None else thr.data_ptr(), int(bool(need_filter)),
            float(show_coeff), float(clk_coeff), float(embed_threshold),
            int(quant_ratio), int(cvm_offset), group, cols, out.data_ptr(),
            _stream(table))
    _check_launch("gather_pool", code)
    gather_pool.launches += 1
    return out


gather_pool.launches = 0


# ---------------------------------------------------------------------------
# scatter_accumulate
# ---------------------------------------------------------------------------

class RowLayout(ctypes.Structure):
    """Mirrors csrc/apply_updates.cuh::RowLayout field for field."""
    _fields_ = [(n, ctypes.c_int32) for n in
                ("fixed_cols", "embed_w_num", "dim", "total_dim",
                 "row_width")] + \
        [(n, ctypes.c_float) for n in
         ("lr", "initial_g2sum", "beta1", "beta2", "one_minus_beta1",
          "one_minus_beta2", "ftrl_l1", "ftrl_l2", "ftrl_beta",
          "mf_create_threshold", "expand_create_threshold")]


OPTIMIZER_CODES = {"sgd": 0, "adagrad": 1, "adam": 2, "ftrl": 3}


def row_layout(cfg: EmbeddingConfig) -> RowLayout:
    """The kernel's view of ``cfg``: column offsets and f32 constants
    (``1 - beta`` is rounded once from the double, as the reference's
    Python constant is)."""
    return RowLayout(
        cfg.fixed_cols, cfg.embed_w_num, cfg.dim, cfg.total_dim,
        cfg.row_width, cfg.learning_rate, cfg.initial_g2sum, cfg.beta1,
        cfg.beta2, 1 - cfg.beta1, 1 - cfg.beta2, cfg.ftrl_l1, cfg.ftrl_l2,
        cfg.ftrl_beta, cfg.mf_create_threshold, cfg.expand_create_threshold)


def scatter_accumulate_supported(n_rows: int, table_width: int) -> bool:
    """Whether the table fits the kernel's row layout (at most 16
    columns on each lane of a 32-lane group)."""
    return n_rows > 0 and 0 < table_width <= SA_MAX_WIDTH


def sa_lane_group(row_width: int) -> tuple[int, int]:
    """(G, CPL): the lanes scatter_accumulate gives one row and the
    columns each of them holds in registers, for a row of ``row_width``
    logical columns — 8 lanes up to 64 columns, 16 up to 128, 32 beyond,
    with 8 columns a lane up to 256 and 16 up to SA_MAX_WIDTH (the
    kernel's four instantiations). A warp then updates 32 / G rows at
    once, and G * CPL >= row_width."""
    w = int(row_width)
    if not 0 < w <= SA_MAX_WIDTH:
        raise ValueError(f"row width {w} outside 1..{SA_MAX_WIDTH}")
    if w <= 64:
        return 8, 8
    if w <= 128:
        return 16, 8
    return (32, 8) if w <= 256 else (32, 16)


def scatter_accumulate_plain(table: torch.Tensor, idx: torch.Tensor,
                             grads: torch.Tensor, shows: torch.Tensor,
                             clks: torch.Tensor, cfg: EmbeddingConfig,
                             touched: torch.Tensor | None = None
                             ) -> torch.Tensor:
    """Plain PyTorch statement of the scatter_accumulate kernel: gather
    each lane's row, apply_updates, write back the valid lanes only (in
    place); returns ``table``."""
    n_rows = table.shape[0]
    in_range = (idx >= 0) & (idx < n_rows)
    rows = table.index_select(0, torch.where(in_range, idx, 0).long())
    new_rows = apply_updates(rows, grads, shows, clks, cfg)
    keep = in_range if touched is None else in_range & (touched > 0)
    table[idx[keep].long()] = new_rows[keep]
    return table


def scatter_accumulate(table: torch.Tensor, idx: torch.Tensor,
                       grads: torch.Tensor, shows: torch.Tensor,
                       clks: torch.Tensor, cfg: EmbeddingConfig,
                       touched: torch.Tensor | None = None) -> torch.Tensor:
    """Row-wise fused merge-apply over premerged unique lanes, in place.

    table : (n_rows, W) f32, W >= cfg.row_width (pad columns pass through)
    idx   : (n,) int32, one lane per touched row (unique among valid
            lanes); out-of-range ids are pads and never write
    grads/shows/clks : the merged per-lane payload (n, grad_width), (n,),
            (n,)
    touched : optional per-lane flag; a lane with touched <= 0 never
            writes (default: every in-range lane)
    Returns ``table``, updated in place (rows no valid lane names keep
    their exact bits)."""
    _require(table.ndim == 2 and table.dtype == torch.float32,
             "table must be a 2-D float32 tensor")
    n_rows, W = table.shape
    _require(scatter_accumulate_supported(n_rows, W),
             f"scatter_accumulate needs 0 < width <= {SA_MAX_WIDTH}, "
             f"got {W}")
    _require(W >= cfg.row_width, f"table width {W} < row_width")
    n = idx.shape[0]
    gw = cfg.grad_width
    _require(grads.shape == (n, gw) and shows.shape == (n,)
             and clks.shape == (n,), "payload shapes do not match idx")
    if table.device.type == "cpu":
        return scatter_accumulate_plain(table, idx, grads, shows, clks, cfg,
                                        touched)
    _require_cuda("scatter_accumulate", table.device, idx=idx, grads=grads,
                  shows=shows, clks=clks)
    _require(table.is_contiguous(), "table must be contiguous")
    _require(idx.dtype == torch.int32 and idx.is_contiguous(),
             "idx must be contiguous int32")
    for k, t in (("grads", grads), ("shows", shows), ("clks", clks)):
        _require(t.dtype == torch.float32, f"{k} must be float32")
    _require(grads.stride(1) == 1, "grads columns must be contiguous")
    tch = None
    if touched is not None:
        _require(touched.shape == (n,) and touched.device == table.device,
                 "touched must be (n,) on the table's device")
        tch = (touched > 0).to(torch.int32).contiguous()
    if n == 0:
        return table
    lib = _lib("scatter_accumulate")
    layout = row_layout(cfg)
    group, cols = sa_lane_group(cfg.row_width)
    with torch.cuda.device(table.device):
        code = lib.pbt_scatter_accumulate(
            table.data_ptr(), n_rows, W, idx.data_ptr(),
            None if tch is None else tch.data_ptr(),
            grads.data_ptr(), grads.stride(0), shows.data_ptr(),
            shows.stride(0), clks.data_ptr(), clks.stride(0), n,
            OPTIMIZER_CODES[cfg.optimizer], group, cols,
            ctypes.byref(layout), _stream(table))
    _check_launch("scatter_accumulate", code)
    scatter_accumulate.launches += 1
    return table


scatter_accumulate.launches = 0


# ---------------------------------------------------------------------------
# binned_merge_acc
# ---------------------------------------------------------------------------

def binned_geometry(cfg: EmbeddingConfig, n_rows: int):
    """(SB, NB) of the binned_merge_acc kernel for an ``n_rows`` table,
    or None where it has none.

    SB, the table rows one thread block accumulates in shared memory, is
    the largest power of two with SB * (grad_width + 3) * 4 bytes <=
    BINNED_SMEM_BYTES, and no more than the table needs; NB = ceil(n_rows
    / SB). The last block is ragged where SB does not divide n_rows, so a
    working set needs no row alignment. (The JAX package's geometry,
    ``_bp_geometry``, is the TPU's: divisible blocks sized for its matrix
    unit.)"""
    n_rows = int(n_rows)
    fit = BINNED_SMEM_BYTES // (4 * (cfg.grad_width + 3))
    if n_rows < 1 or fit < 1:
        return None
    sb = min(1 << (fit.bit_length() - 1), 1 << (n_rows - 1).bit_length())
    return sb, -(-n_rows // sb)


def wide_rows(cfg: EmbeddingConfig) -> bool:
    """The JAX package's wide push rows: a payload of more than 64 lanes
    once padded to a multiple of 8 (one lane group in its binned kernel,
    ``pallas_kernels.lane_groups(...) == 1``). Auto premerges them and
    keeps them off the binned engine."""
    return -(-(cfg.grad_width + 3) // 8) * 8 > 64


def device_block_plan(idx: torch.Tensor, super_block: int, n_blocks: int
                      ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The token grouping binned_merge_acc makes on the device when no
    host plan comes with the batch (``_bp_pack``'s argsort +
    searchsorted): (order, rstart, end) int32 on idx's device. Negative
    ids sort before block 0's window and ids past the last block after
    its window, so no window holds them; ids in the ragged tail of the
    last block fall in its window and the kernel's row-range check drops
    them."""
    s, order = torch.sort(idx.long())
    edges = torch.arange(n_blocks + 1, dtype=torch.int64,
                         device=idx.device) * super_block
    bounds = torch.searchsorted(s, edges).to(torch.int32)
    return (order.to(torch.int32), bounds[:-1].contiguous(),
            bounds[1:].contiguous())


def binned_merge_acc_plain(idx: torch.Tensor, grads: torch.Tensor,
                           shows: torch.Tensor, clks: torch.Tensor,
                           cfg: EmbeddingConfig, n_rows: int
                           ) -> torch.Tensor:
    """Plain PyTorch statement of the binned_merge_acc kernel: one
    ``index_add_`` of the token payload [grads, show, clk, 1] into an
    (n_rows + 1, grad_width + 3) accumulator whose spare last row takes
    the out-of-range ids, sliced off. This is also the xla_scatter
    engine's accumulator."""
    n = idx.shape[0]
    payload = torch.cat([grads, shows[:, None], clks[:, None],
                         grads.new_ones((n, 1))], dim=1)
    safe = torch.where((idx >= 0) & (idx < n_rows), idx, n_rows).long()
    acc = grads.new_zeros((n_rows + 1, cfg.grad_width + 3))
    return acc.index_add_(0, safe, payload)[:n_rows]


def binned_merge_acc(idx: torch.Tensor, grads: torch.Tensor,
                     shows: torch.Tensor, clks: torch.Tensor,
                     cfg: EmbeddingConfig, n_rows: int,
                     plan=None) -> torch.Tensor:
    """The binned push's merge half: the (n_rows, grad_width + 3) per-row
    accumulator [sum of grads, sum of shows, sum of clks, token count]
    from a token stream with duplicates; ids outside [0, n_rows) are
    dropped.

    idx : (n,) int32; grads (n, grad_width), shows / clks (n,) f32
    plan : the grouping of tokens by binned_geometry's super-blocks —
        (order, rstart, end) from ``native.key_index.block_plan``, or
        (None, rstart, end) windows over lanes already sorted by row (the
        dedup plan's) — or None to group on the device
        (device_block_plan). The plain version needs no grouping.
    Grad columns are f32 sums in an order that varies from run to run;
    the show, clk and count columns are exact."""
    geom = binned_geometry(cfg, n_rows)
    _require(geom is not None,
             f"binned_merge_acc has no geometry for {n_rows} rows of "
             f"grad_width {cfg.grad_width}")
    n = idx.shape[0]
    gw = cfg.grad_width
    _require(grads.shape == (n, gw) and shows.shape == (n,)
             and clks.shape == (n,), "payload shapes do not match idx")
    if idx.device.type == "cpu":
        return binned_merge_acc_plain(idx, grads, shows, clks, cfg, n_rows)
    _require_cuda("binned_merge_acc", idx.device, grads=grads, shows=shows,
                  clks=clks)
    _require(idx.dtype == torch.int32 and idx.is_contiguous(),
             "idx must be contiguous int32")
    for k, t in (("grads", grads), ("shows", shows), ("clks", clks)):
        _require(t.dtype == torch.float32, f"{k} must be float32")
    _require(grads.stride(1) == 1, "grads columns must be contiguous")
    SB, NB = geom
    if plan is None:
        plan = device_block_plan(idx, SB, NB)
    order, rstart, end = plan
    parts = [("rstart", rstart, NB), ("end", end, NB)]
    if order is not None:
        parts.append(("order", order, n))
    for k, t, size in parts:
        _require(t.shape == (size,) and t.dtype == torch.int32
                 and t.is_contiguous() and t.device == idx.device,
                 f"plan {k} must be contiguous int32 ({size},) on "
                 f"{idx.device}")
    acc = torch.empty((n_rows, gw + 3), dtype=torch.float32,
                      device=idx.device)
    lib = _lib("binned_merge_acc")
    with torch.cuda.device(idx.device):
        code = lib.pbt_binned_merge_acc(
            idx.data_ptr(), grads.data_ptr(), grads.stride(0),
            shows.data_ptr(), shows.stride(0), clks.data_ptr(),
            clks.stride(0), None if order is None else order.data_ptr(),
            rstart.data_ptr(), end.data_ptr(), n_rows, SB, gw,
            acc.data_ptr(), _stream(idx))
    _check_launch("binned_merge_acc", code)
    binned_merge_acc.launches += 1
    return acc


binned_merge_acc.launches = 0


# ---------------------------------------------------------------------------
# merge_update
# ---------------------------------------------------------------------------

def mu_lane_group(row_width: int) -> tuple[int, int]:
    """(G, CPL): the lanes merge_update gives one touched row and the
    columns each of them holds, for a row of ``row_width`` logical
    columns — 4 lanes x 4 columns up to 16 columns (a warp updates eight
    rows a round), else scatter_accumulate's group (sa_lane_group). Refuses
    widths past SA_MAX_WIDTH."""
    w = int(row_width)
    if 0 < w <= 16:
        return 4, 4
    return sa_lane_group(w)


def merge_update_plain(table: torch.Tensor, acc: torch.Tensor,
                       cfg: EmbeddingConfig) -> torch.Tensor:
    """Plain PyTorch statement of the merge_update kernel:
    ``apply_updates`` over the whole table, kept where the touch count is
    > 0 (in place); returns ``table``."""
    gw = cfg.grad_width
    new_rows = apply_updates(table, acc[:, :gw], acc[:, gw], acc[:, gw + 1],
                             cfg)
    touched = acc[:, gw + 2] > 0
    return table.copy_(torch.where(touched[:, None], new_rows, table))


def merge_update(table: torch.Tensor, acc: torch.Tensor,
                 cfg: EmbeddingConfig) -> torch.Tensor:
    """The masked optimizer pass: apply the accumulated push to every row
    whose touch count ``acc[:, grad_width + 2]`` is > 0, in place.

    table : (n_rows, W) f32, W >= cfg.row_width (pad columns pass
            through); on the card W <= 512
    acc   : (n_rows, grad_width + 3) f32 [summed grads, show, clk, count]
    Returns ``table``; rows with no touch keep their exact bits. (The
    JAX kernel returns a new table.)"""
    _require(table.ndim == 2 and table.dtype == torch.float32,
             "table must be a 2-D float32 tensor")
    n_rows, W = table.shape
    _require(W >= cfg.row_width, f"table width {W} < row_width")
    _require(acc.shape == (n_rows, cfg.grad_width + 3),
             f"acc must be ({n_rows}, {cfg.grad_width + 3}), got "
             f"{tuple(acc.shape)}")
    if table.device.type == "cpu":
        return merge_update_plain(table, acc, cfg)
    _require_cuda("merge_update", table.device, acc=acc)
    _require(W <= SA_MAX_WIDTH,
             f"merge_update needs width <= {SA_MAX_WIDTH}, got {W}")
    _require(table.is_contiguous(), "table must be contiguous")
    _require(acc.dtype == torch.float32 and acc.is_contiguous(),
             "acc must be contiguous float32")
    if n_rows == 0:
        return table
    lib = _lib("merge_update")
    layout = row_layout(cfg)
    group, cols = mu_lane_group(cfg.row_width)
    with torch.cuda.device(table.device):
        code = lib.pbt_merge_update(
            table.data_ptr(), n_rows, W, acc.data_ptr(), acc.shape[1],
            OPTIMIZER_CODES[cfg.optimizer], group, cols,
            ctypes.byref(layout), _stream(table))
    _check_launch("merge_update", code)
    merge_update.launches += 1
    return table


merge_update.launches = 0


def binned_push(table: torch.Tensor, idx: torch.Tensor,
                grads: torch.Tensor, shows: torch.Tensor,
                clks: torch.Tensor, cfg: EmbeddingConfig,
                plan=None) -> torch.Tensor:
    """The binned_kernel push engine, in place: binned_merge_acc, then
    merge_update. Same contract as the JAX package's ``binned_push``
    (duplicates merged before the optimizer, out-of-range ids dropped,
    untouched rows bit-identical) up to f32 summation order; ``plan`` as
    for binned_merge_acc. Returns ``table``."""
    acc = binned_merge_acc(idx, grads, shows, clks, cfg, table.shape[0],
                           plan=plan)
    return merge_update(table, acc, cfg)


# ---------------------------------------------------------------------------
# push-engine registry + resolver
# ---------------------------------------------------------------------------

PUSH_ENGINES = ("xla_scatter", "binned_kernel", "scatter_accumulate")
_PUSH_ENGINE_ALIASES = {"kernel": "binned_kernel",
                        "scatter": "xla_scatter",
                        "fused": "scatter_accumulate"}


def normalize_push_engine(eng: str) -> str:
    """Canonical engine name for a flags.push_engine value."""
    return _PUSH_ENGINE_ALIASES.get(eng, eng)


def push_engine_flag() -> str:
    """The validated ``flags.push_engine``."""
    eng = normalize_push_engine(flags.push_engine)
    if eng != "auto" and eng not in PUSH_ENGINES:
        raise ValueError(
            f"push_engine={flags.push_engine!r} (want 'auto', one of "
            f"{PUSH_ENGINES}, or the legacy 'kernel'/'scatter'/'fused' "
            f"aliases)")
    return eng


def resolve_push_engine(cfg: EmbeddingConfig, n_rows: int, *,
                        premerged: bool, device_type: str,
                        table_width: int | None = None) -> str:
    """THE push merge-engine resolver (the JAX package's, with the card
    in place of the TPU).

    premerged : the lanes reaching the engine are one-lane-per-unique-row
        (the dedup pre-merge's output); the fused engine requires it.
    Auto on the card: premerged f32 lanes take ``scatter_accumulate``;
    narrow raw token streams (not wide_rows) take ``binned_kernel`` while
    ``flags.binned_push`` is set; the rest take ``xla_scatter``. Off the
    card auto is ``xla_scatter``, as the JAX package's is off-TPU. A
    forced engine engages wherever its contract holds, on the CPU
    through the plain versions: ``scatter_accumulate`` needs premerged
    lanes, ``binned_kernel`` a binned_geometry (and ignores
    ``flags.binned_push``: an enable knob must not void an explicit
    force). Both kernels that update rows in place cap the width at
    SA_MAX_WIDTH."""
    eng = push_engine_flag()
    width = int(table_width) if table_width is not None else cfg.row_width
    f32 = cfg.storage == "f32"
    sa_ok = premerged and f32 and scatter_accumulate_supported(n_rows, width)
    binned_ok = (f32 and width <= SA_MAX_WIDTH
                 and binned_geometry(cfg, n_rows) is not None)
    if eng == "xla_scatter":
        return "xla_scatter"
    if eng == "scatter_accumulate":
        return "scatter_accumulate" if sa_ok else "xla_scatter"
    if eng == "binned_kernel":
        return "binned_kernel" if binned_ok else "xla_scatter"
    if device_type != "cuda":
        return "xla_scatter"
    if sa_ok:
        return "scatter_accumulate"
    if flags.binned_push and binned_ok and not wide_rows(cfg):
        return "binned_kernel"
    return "xla_scatter"
