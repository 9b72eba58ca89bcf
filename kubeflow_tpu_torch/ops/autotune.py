"""Kernel autotune plane: shape-keyed tile tables for the CUDA kernels.

PyTorch/CUDA twin of ``kubeflow_tpu/ops/autotune.py``. The vocabulary is
the reference's: a **kernel key** (``flash_fwd`` / ``flash_bwd_dq`` /
``flash_bwd_dkv`` / ``paged_attn``) plus a **shape class** (seq bucket,
head_dim, n_heads / n_kv_heads, dtype, causal, backend generation, page
size) maps to a committed tile config in ``ops/tile_table.json``; the
most specific matching row wins (:meth:`TileTable.lookup`); explicit
knobs win over the table (``source="override"``); a shape class with no
row takes the analytic fallback; every resolution can be recorded
(:func:`record_resolutions`).

What differs is the legality and the knobs, which are Hopper's:

- ``generation`` is ``sm_90`` on an H100 (``torch.cuda.
  get_device_capability``), ``cpu`` without a card;
- a **flash** row is legal only with a tile the CUDA kernel of its
  key is compiled for at the row's head dim and dtype
  (:func:`flash_tiles`): at bf16 and D <= 64 the forward owns 192 q rows
  an item (three consumer warpgroups) or 64 (one; two blocks an SM) over
  64-key stages (``csrc/flash_attention.cu`` ``FwdGeom``, ``kFwdStep``),
  and the backward, one kernel for dQ and dK/dV, 64 q rows x 128 keys
  under both keys (``kWgStep``/``kWgTile``); every other kernel (f32,
  D = 128, D = 256 and past it) runs 64 x 64 (``kBQ``/``kBK``). The
  forward's rows are the grid's, not a row's: :func:`flash_tile` takes
  the tile whose grid ends first on the card's SMs
  (:func:`forward_rounds`): the 64-row tile runs three times the items,
  two blocks an SM, so it wins where the 192-row tile's last round
  would leave SMs idle. A row that leaves open a field deciding which
  kernel runs is illegal. The reference's ``block_q``/``block_k`` are
  TPU tile edges. A caller's explicit knobs (a reference config's
  ``attention_block_q/k``) are recorded as an override, and a table
  row as a table row: the kernels run :func:`flash_tile`'s tile
  whatever resolves — never a refusal;
- a **paged** row's knob is ``split_tokens``, the keys of a split of a
  row's pages in ``csrc/paged_attention.cu``: the port's counterpart of
  the reference's ``head_block`` (the kernels take q heads in blocks of
  at most 8 by themselves). Two kernels share it, chosen by
  :func:`paged_route` from the dtype, head dim and GQA group:
  ``paged_decode_tma_kernel`` (bf16, head dim 64, groups to 8; it cuts
  only rows it does not take whole) and ``paged_decode_kernel`` (the
  rest). A row is legal when the split is a whole number of pages and
  the block's dynamic shared memory (:func:`paged_smem_bytes`, a copy of
  the C ``kftpu_paged_decode_smem_bytes``) fits the route's limit
  (:func:`paged_smem_limit`): ``OPT_IN_SMEM_BYTES`` for the TMA kernel,
  which opts in, ``MAX_SMEM_BYTES`` for the other, which does not. The
  fallback is the wrapper's analytic choice: about ``SPLIT_TOKENS``
  keys, halved while the block would not fit.

An illegal row is rejected at load with a warning (strict loads raise)
and its shape class takes the fallback: a table row the kernel cannot
take never reaches a launch.

Nothing here imports torch at module level or touches the card at
import; :func:`backend_generation` asks the card lazily.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import os
import warnings
from typing import Any, Dict, Iterator, List, Optional, Tuple

KERNELS = ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv", "paged_attn")

MIN_SEQ_BUCKET = 128
# the flash kernels' tile (block_q, block_k): q rows and keys a block
# (csrc kBQ, kBK), for the mma.sync and FMA kernels
FLASH_TILE = (64, 64)
# bf16 at head dims up to WGMMA_HEAD_DIM (padded to it): the wgmma
# kernels' (block_q, block_k). The forward: 192 q rows an item (csrc
# FwdGeom<3>) over 64-key stages (kFwdStep), or on a short grid
# WGMMA_FWD_SHORT_TILE, 64 rows an item (FwdGeom<1>, two blocks an SM).
# The fused backward (dQ, dK and dV in one kernel): 64-row q stages
# walked by 128-key blocks (kWgStep, kWgTile)
WGMMA_HEAD_DIM = 64
WGMMA_TILES = {"flash_fwd": (192, 64), "flash_bwd": (64, 128)}
WGMMA_FWD_SHORT_TILE = (64, 64)
# the forward's rows an item -> (its blocks an SM, csrc FwdGeom's: one
# 192-row block, two 64-row ones; a round's time relative to a 64-row
# round, 1.15 at phase 2's non-causal shapes on an NVIDIA H100 80GB HBM3
# at 700 W, PERF.md §6 row 3; the hand-off design reads 1.07 and 1.08
# at the two :predict shapes and 1.17 at BERT-base's, the one timed
# shape whose grids differ in rounds (5 against 6): any cost in (1, 1.2)
# picks the faster tile at every timed shape,
# scripts/port_flash_bwd_ab.py --rows)
FWD_ROUNDS = {192: (1, 1.15), 64: (2, 1.0)}
# the wgmma kernel each reference key runs (both backward keys: the fused one)
WGMMA_KERNEL = {"flash_fwd": "flash_fwd", "flash_bwd_dq": "flash_bwd",
                "flash_bwd_dkv": "flash_bwd", "flash_bwd": "flash_bwd"}
# dynamic shared memory a launch may take without the opt-in attribute
MAX_SMEM_BYTES = 48 * 1024
# ... and with it (cudaFuncAttributeMaxDynamicSharedMemorySize): a
# block's most on Hopper, 227 KB
OPT_IN_SMEM_BYTES = 232448
# the paged wrapper's analytic split: about this many keys a block
SPLIT_TOKENS = 128
# the dtypes the CUDA kernels take
DTYPE_BYTES = {"float32": 4, "bfloat16": 2}

# csrc/paged_attention.cu's block geometry (kThreads, kWarps, kKeys,
# kMaxGroup), for the Python copy of its shared-memory formula
_PAGED_THREADS = 128
_PAGED_WARPS = _PAGED_THREADS // 32
_PAGED_KEYS = 4
PAGED_MAX_GROUP = 8
# the paged kernels: the TMA route (bf16 at head dim 64, groups of at
# most PAGED_MAX_GROUP q heads) and the split kernel (every other shape)
PAGED_TMA_KERNEL = "paged_decode_tma_kernel"
PAGED_SPLIT_KERNEL = "paged_decode_kernel"
PAGED_TMA_HEAD_DIM = 64
# csrc/paged_attention.cu's tma:: layout: kStages ring stages of kRows
# K and V rows (128 bytes each), kConsumerWarps warps' partials of up to
# 8 heads, a meta int4 and two barriers a stage, the list's kMaxRows rows
# (5 ints each, one more prefix entry), kMisc ints and kPageCache page ids
_TMA_STAGES, _TMA_ROWS, _TMA_WARPS = 4, 64, 8
_TMA_MAX_ROWS, _TMA_MISC, _TMA_PAGE_CACHE = 1024, 5, 2048
# where a paged row leaves a field open, it is checked at the widest
# shape the kernel takes: the most shared memory a block can need
_PAGED_STRICTEST = {"head_dim": 256, "group": PAGED_MAX_GROUP,
                    "page_size": 1, "el": 4}

_WILDCARD = (None, "*")


def dtype_name(dtype: Any) -> str:
    """Canonical dtype string for table keys (``torch.bfloat16``,
    ``np.dtype`` and plain strings all normalize the same way)."""
    if isinstance(dtype, str):
        return dtype
    name = getattr(dtype, "name", None)
    if name:
        return str(name)
    name = getattr(dtype, "__name__", None)
    if name:
        return str(name)
    text = str(dtype)
    return text[len("torch."):] if text.startswith("torch.") else text


def seq_bucket(seq: int) -> int:
    """Power-of-two shape-class bucket covering ``seq`` (min 128)."""
    b = MIN_SEQ_BUCKET
    while b < seq:
        b *= 2
    return b


def fit_block(seq: int, block: int) -> int:
    """Largest divisor of ``seq`` that is ≤ ``block`` (the reference's
    fitting of a table value to the actual shape)."""
    block = max(1, min(int(block), int(seq)))
    for b in range(block, 0, -1):
        if seq % b == 0:
            return b
    return 1


_GENERATIONS: Dict[Optional[int], str] = {}
_SMS: Dict[Optional[int], int] = {}


def backend_generation(device: Any = None) -> str:
    """Chip-generation component of the shape class: ``sm_<major><minor>``
    of the CUDA card (``device``, or the current one), ``cpu`` for a CPU
    device or where there is no card."""
    import torch

    if device is not None:
        device = torch.device(device)
        if device.type != "cuda":
            return "cpu"
    if not torch.cuda.is_available():
        return "cpu"
    index = device.index if device is not None else None
    gen = _GENERATIONS.get(index)
    if gen is None:
        major, minor = torch.cuda.get_device_capability(index)
        gen = _GENERATIONS[index] = f"sm_{major}{minor}"
    return gen


def sm_count(device: Any) -> Optional[int]:
    """The SMs of the CUDA card ``device``; None for any other device."""
    import torch

    device = torch.device(device)
    if device.type != "cuda":
        return None
    sms = _SMS.get(device.index)
    if sms is None:
        sms = _SMS[device.index] = torch.cuda.get_device_properties(
            device).multi_processor_count
    return sms


# ---------------------------------------------------------------------------
# Hopper legality: the flash kernels' compiled tiles
# ---------------------------------------------------------------------------


def _wgmma(kernel: str, head_dim: int, dtype: Any) -> bool:
    """Whether ``kernel`` runs a wgmma kernel at this head dim and dtype:
    bf16 at head dims up to ``WGMMA_HEAD_DIM`` (the wrapper pads those
    to it)."""
    return (kernel in WGMMA_KERNEL and dtype_name(dtype) == "bfloat16"
            and head_dim <= WGMMA_HEAD_DIM)


def flash_tiles(kernel: str, head_dim: int, dtype: Any) -> frozenset:
    """Every ``(block_q, block_k)`` the CUDA kernel of ``kernel`` is
    compiled for at a ``head_dim``-wide input of ``dtype``: the wgmma
    forward's two, else the one of :func:`flash_tile`."""
    if WGMMA_KERNEL.get(kernel) == "flash_fwd" and _wgmma(kernel, head_dim,
                                                          dtype):
        return frozenset({WGMMA_TILES["flash_fwd"], WGMMA_FWD_SHORT_TILE})
    return frozenset({flash_tile(kernel, head_dim, dtype)})


def flash_tile(kernel: str, head_dim: int, dtype: Any, *,
               batch_heads: Optional[int] = None,
               seq: Optional[int] = None,
               sms: Optional[int] = None) -> Tuple[int, int]:
    """``(block_q, block_k)`` the CUDA kernel of ``kernel`` runs for a
    ``head_dim``-wide input of ``dtype``: the wgmma tile of bf16 at head
    dims up to ``WGMMA_HEAD_DIM``, else ``FLASH_TILE``. The wgmma
    forward given ``batch_heads`` (B * H), ``seq`` and the card's
    ``sms`` takes ``WGMMA_FWD_SHORT_TILE`` where its grid ends first
    (:func:`forward_rounds`)."""
    if not _wgmma(kernel, head_dim, dtype):
        return FLASH_TILE
    tile = WGMMA_TILES[WGMMA_KERNEL[kernel]]
    if (WGMMA_KERNEL[kernel] == "flash_fwd"
            and None not in (batch_heads, seq, sms)
            and forward_rounds(WGMMA_FWD_SHORT_TILE[0], batch_heads, seq,
                               sms)
            < forward_rounds(tile[0], batch_heads, seq, sms)):
        return WGMMA_FWD_SHORT_TILE
    return tile


def forward_rounds(rows: int, batch_heads: int, seq: int, sms: int) -> float:
    """The wgmma forward's grid time at ``rows`` q rows an item, in
    64-row rounds: the rounds its ``batch_heads * ceil(seq / rows)``
    items take at ``FWD_ROUNDS``' blocks an SM on ``sms`` SMs, each at
    its tile's relative cost."""
    per_sm, cost = FWD_ROUNDS[rows]
    items = batch_heads * -(-seq // rows)
    return -(-items // (per_sm * sms)) * cost


def _row_tiles(entry: Dict[str, Any]) -> set:
    """The sets of tiles the kernel of a flash row's key is compiled for
    over every shape the row can match (one set, unless an open field
    decides)."""
    head_dim, dtype = entry.get("head_dim"), entry.get("dtype")
    dims = ((WGMMA_HEAD_DIM, WGMMA_HEAD_DIM + 1) if head_dim in _WILDCARD
            else (head_dim,))
    dtypes = tuple(DTYPE_BYTES) if dtype in _WILDCARD else (dtype,)
    return {flash_tiles(entry["kernel"], d, t) for d in dims for t in dtypes}


# ---------------------------------------------------------------------------
# Hopper legality: the paged block's shared memory
# ---------------------------------------------------------------------------


def paged_route(group: int, head_dim: int, el: int) -> str:
    """The paged kernel that runs at a GQA ``group``, ``head_dim`` and
    ``el``-byte dtype: a copy of ``csrc/paged_attention.cu:tma_route``."""
    if (el == 2 and head_dim == PAGED_TMA_HEAD_DIM
            and group <= PAGED_MAX_GROUP):
        return PAGED_TMA_KERNEL
    return PAGED_SPLIT_KERNEL


def paged_tma_smem_bytes() -> int:
    """Dynamic shared memory of one ``paged_decode_tma_kernel`` block, a
    copy of the C ``tma::kSmem``: the slack to a 1024-byte boundary, the
    ring, the warps' partials, the stages' meta and barriers, the work
    list. It does not depend on the split."""
    ring = _TMA_STAGES * 2 * _TMA_ROWS * PAGED_TMA_HEAD_DIM * 2
    red = _TMA_WARPS * PAGED_MAX_GROUP * (PAGED_TMA_HEAD_DIM + 2) * 4
    meta, bars = _TMA_STAGES * 16, _TMA_STAGES * 2 * 8
    lists = (5 * _TMA_MAX_ROWS + 1 + _TMA_MISC + _TMA_PAGE_CACHE) * 4
    return 1024 + ring + red + meta + bars + lists


def paged_smem_limit(group: int, head_dim: int, el: int) -> int:
    """The dynamic shared memory the route at this shape may take: the
    TMA kernel opts in (``OPT_IN_SMEM_BYTES``), the split kernel does not
    (``MAX_SMEM_BYTES``)."""
    if paged_route(group, head_dim, el) == PAGED_TMA_KERNEL:
        return OPT_IN_SMEM_BYTES
    return MAX_SMEM_BYTES


def paged_smem_bytes(group: int, head_dim: int, el: int, pps: int) -> int:
    """Dynamic shared memory of one block of the paged kernel that runs
    at this shape (:func:`paged_route`): the TMA kernel's fixed layout
    (:func:`paged_tma_smem_bytes`), or a copy of the split kernel's
    ``csrc/paged_attention.cu:smem_bytes`` (the 2-stage K/V ring, or the
    cross-warp partials it turns into once drained, whichever is larger,
    then the split's ``pps`` page ids)."""
    if paged_route(group, head_dim, el) == PAGED_TMA_KERNEL:
        return paged_tma_smem_bytes()
    chunks = head_dim * el // 16
    slices = 2 if chunks > 32 else 1
    need = -(-chunks // slices)
    lanes = 1
    while lanes < need:
        lanes <<= 1
    stage_rows = _PAGED_KEYS // slices * (_PAGED_THREADS // lanes)
    heads = min(group, PAGED_MAX_GROUP)
    ring = 4 * stage_rows * head_dim * el
    red = _PAGED_WARPS * heads * (head_dim + 2) * 4
    return max(ring, red) + pps * 4


def paged_legality_point(entry: Dict[str, Any]) -> Tuple[int, int, int, int]:
    """``(group, head_dim, el, pps)`` a ``paged_attn`` row is checked at:
    its own fields, and the strictest value where a field is open."""
    n_heads, n_kv = entry.get("n_heads"), entry.get("n_kv_heads")
    if n_heads in _WILDCARD or n_kv in _WILDCARD:
        group = _PAGED_STRICTEST["group"]
    else:
        group = max(1, int(n_heads) // max(1, int(n_kv)))
    head_dim = entry.get("head_dim")
    if head_dim in _WILDCARD:
        head_dim = _PAGED_STRICTEST["head_dim"]
    dtype = entry.get("dtype")
    el = (DTYPE_BYTES.get(dtype, _PAGED_STRICTEST["el"])
          if dtype not in _WILDCARD else _PAGED_STRICTEST["el"])
    page_size = entry.get("page_size")
    if page_size in _WILDCARD:
        page_size = _PAGED_STRICTEST["page_size"]
    pps = max(1, int(entry.get("split_tokens") or 1) // int(page_size))
    return group, int(head_dim), el, pps


# ---------------------------------------------------------------------------
# Table entries: schema, validation, matching
# ---------------------------------------------------------------------------

# Entry schema (one JSON object per shape class):
#   kernel      str, one of KERNELS                          (required)
#   seq_bucket  int pow2 — required for flash kernels, optional
#               (wildcard) for paged_attn
#   head_dim / n_heads / n_kv_heads   int or null (wildcard)
#   dtype       canonical dtype str or "*"/null
#   causal      bool or null
#   generation  backend_generation() slug or "*"/null
#   page_size   int or null — paged_attn only
#   block_q / block_k   int — flash kernels (a tile of flash_tiles)
#   split_tokens        int — paged_attn (keys a split block takes)
#   provenance  str — where the numbers came from

_MATCH_FIELDS = ("head_dim", "n_heads", "n_kv_heads", "dtype", "causal",
                 "generation", "page_size")


def entry_key(entry: Dict[str, Any]) -> str:
    """Compact human identity for messages and sweep output."""
    parts = [str(entry.get("kernel", "?"))]
    sb = entry.get("seq_bucket")
    parts.append(f"s{sb}" if sb else "s*")
    for field, tag in (("head_dim", "d"), ("n_heads", "h"),
                       ("n_kv_heads", "kv"), ("page_size", "p")):
        v = entry.get(field)
        if v not in _WILDCARD:
            parts.append(f"{tag}{v}")
    dt = entry.get("dtype")
    parts.append(dt if dt not in _WILDCARD else "*")
    causal = entry.get("causal")
    if causal is not None:
        parts.append("causal" if causal else "bidir")
    gen = entry.get("generation")
    if gen not in _WILDCARD:
        parts.append(str(gen))
    return "/".join(parts)


def _int_field(entry: Dict[str, Any], field: str,
               errs: List[str]) -> Optional[int]:
    v = entry.get(field)
    if v in _WILDCARD:
        return None
    if not isinstance(v, int) or isinstance(v, bool) or v < 1:
        errs.append(f"{field} must be a positive int or null, got {v!r}")
        return None
    return v


def validate_entry(entry: Dict[str, Any],
                   smem_limit: Optional[int] = None) -> List[str]:
    """All the reasons ``entry`` is illegal on Hopper (empty list =
    legal): the flash kernel's compiled tiles (:func:`flash_tiles`), the
    paged split's whole pages and its block's shared memory against
    ``smem_limit`` (by default the limit of the route that runs at the
    row's legality point, :func:`paged_smem_limit`)."""
    errs: List[str] = []
    kernel = entry.get("kernel")
    if kernel not in KERNELS:
        return [f"unknown kernel {kernel!r}; valid: {KERNELS}"]
    dtype = entry.get("dtype")
    if dtype not in _WILDCARD and dtype not in DTYPE_BYTES:
        errs.append(f"unknown dtype {dtype!r}; known: "
                    f"{sorted(DTYPE_BYTES)} or \"*\"")
    sb = _int_field(entry, "seq_bucket", errs)
    if sb is not None and sb & (sb - 1):
        errs.append(f"seq_bucket {sb} must be a power of two")
        sb = None
    _int_field(entry, "head_dim", errs)
    n_heads = _int_field(entry, "n_heads", errs)
    n_kv = _int_field(entry, "n_kv_heads", errs)
    if n_heads is not None and n_kv is not None and n_heads % n_kv:
        errs.append(f"n_heads {n_heads} is not a multiple of n_kv_heads "
                    f"{n_kv}")

    if kernel == "paged_attn":
        st = entry.get("split_tokens")
        if not isinstance(st, int) or isinstance(st, bool) or st < 1:
            errs.append(f"split_tokens must be a positive int, got {st!r}")
            return errs
        page_size = _int_field(entry, "page_size", errs)
        if page_size is not None and st % page_size:
            errs.append(f"split_tokens {st} is not a whole number of "
                        f"{page_size}-token pages")
        if errs:
            return errs
        group, head_dim, el, pps = paged_legality_point(entry)
        smem = paged_smem_bytes(group, head_dim, el, pps)
        limit = (smem_limit if smem_limit is not None
                 else paged_smem_limit(group, head_dim, el))
        if smem > limit:
            errs.append(f"shared memory {smem} bytes of a "
                        f"{paged_route(group, head_dim, el)} block (group "
                        f"{group}, head_dim {head_dim}, {el}-byte dtype, "
                        f"{pps} pages) exceeds the {limit}-byte launch "
                        "limit")
        return errs

    # flash kernels: the compiled tile only
    if sb is None and "seq_bucket must" not in " ".join(errs):
        errs.append(f"{kernel} entries require a concrete seq_bucket")
    bq = _int_field(entry, "block_q", errs)
    bk = _int_field(entry, "block_k", errs)
    if bq is None or bk is None:
        if "block_q" not in entry or "block_k" not in entry:
            errs.append(f"{kernel} entries require block_q and block_k")
        return errs
    if errs:
        return errs
    tiles = _row_tiles(entry)
    if len(tiles) > 1:
        errs.append(f"{kernel} runs the tiles "
                    f"{sorted(sorted(t) for t in tiles)} over the shapes "
                    "this row matches: pin head_dim and dtype")
    else:
        (legal,) = tiles
        if (bq, bk) not in legal:
            names = " or ".join(f"{tq} x {tk}" for tq, tk in sorted(legal))
            errs.append(f"block_q x block_k {bq} x {bk} is not a tile "
                        f"{kernel} is compiled for at this head_dim and "
                        f"dtype: {names} (csrc kBQ/kBK, FwdGeom/kFwdStep "
                        "or kWgStep/kWgTile)")
    return errs


def _entry_sort_key(entry: Dict[str, Any]) -> Tuple:
    return (str(entry.get("kernel", "")),
            entry.get("seq_bucket") or 0,
            str(entry.get("dtype") or "*"),
            not bool(entry.get("causal")),
            str(entry.get("generation") or "*"),
            entry.get("head_dim") or 0,
            entry.get("n_heads") or 0)


@dataclasses.dataclass
class TileTable:
    """A loaded tile table: validated entries plus the rejects."""

    entries: List[Dict[str, Any]]
    rejected: List[Tuple[Dict[str, Any], List[str]]]
    path: Optional[str] = None
    version: int = 1

    def lookup(self, kernel: str, *, seq: int, head_dim: int,
               n_heads: int, n_kv_heads: int, dtype: Any, causal: bool,
               generation: str,
               page_size: Optional[int] = None) -> Optional[Dict[str, Any]]:
        """Most-specific entry matching the shape class, or None.

        A field matches when the entry pins the same value or carries a
        wildcard; specificity = count of concretely-matched fields, so
        a chip-generation-pinned row outranks a ``"*"`` row.
        """
        bucket = seq_bucket(seq)
        want = {"head_dim": head_dim, "n_heads": n_heads,
                "n_kv_heads": n_kv_heads, "dtype": dtype_name(dtype),
                "causal": bool(causal), "generation": generation,
                "page_size": page_size}
        best, best_score = None, -1
        for e in self.entries:
            if e.get("kernel") != kernel:
                continue
            esb = e.get("seq_bucket")
            if esb is not None and esb != bucket:
                continue
            score = 1 if esb is not None else 0
            ok = True
            for field in _MATCH_FIELDS:
                ev = e.get(field)
                if ev in _WILDCARD:
                    continue
                if want[field] is None or ev != want[field]:
                    ok = False
                    break
                score += 1
            if ok and score > best_score:
                best, best_score = e, score
        return best

    def to_dict(self) -> Dict[str, Any]:
        entries = sorted(self.entries, key=_entry_sort_key)
        return {"version": self.version,
                "smem_limit_bytes": {
                    PAGED_SPLIT_KERNEL: MAX_SMEM_BYTES,
                    PAGED_TMA_KERNEL: OPT_IN_SMEM_BYTES},
                "entries": entries}


DEFAULT_TABLE_PATH = os.path.join(
    os.path.dirname(os.path.abspath(__file__)), "tile_table.json")


def load_table(path: Optional[str] = None, *, strict: bool = False,
               warn: bool = True) -> TileTable:
    """Load and validate a tile table.

    Non-strict (the runtime path): an unreadable file or an illegal
    entry is never a failure — bad rows are dropped with a warning and
    the fallback serves their shape classes. Strict: any problem raises.
    """
    path = path or DEFAULT_TABLE_PATH
    if not os.path.exists(path):
        if strict:
            raise FileNotFoundError(f"tile table missing: {path}")
        return TileTable([], [], path=path)
    try:
        with open(path, encoding="utf-8") as f:
            raw = json.load(f)
    except (ValueError, OSError) as e:
        if strict:
            raise ValueError(f"tile table {path} is unreadable or not "
                             f"valid JSON: {e}")
        if warn:
            warnings.warn(f"tile table {path} unreadable ({e}); "
                          "falling back to analytic tile selection",
                          stacklevel=2)
        return TileTable([], [({}, [f"table unreadable or not valid "
                                    f"JSON: {e}"])], path=path)
    entries: List[Dict[str, Any]] = []
    rejected: List[Tuple[Dict[str, Any], List[str]]] = []
    for entry in raw.get("entries", []):
        errs = validate_entry(entry)
        if errs:
            if strict:
                raise ValueError(
                    f"tile table {path} entry {entry_key(entry)} is "
                    f"illegal: {'; '.join(errs)}")
            if warn:
                warnings.warn(
                    f"tile table entry {entry_key(entry)} rejected "
                    f"({'; '.join(errs)}); the analytic fallback serves "
                    "this shape class", stacklevel=2)
            rejected.append((entry, errs))
        else:
            entries.append(entry)
    return TileTable(entries, rejected, path=path,
                     version=int(raw.get("version", 1)))


def save_table(table: TileTable, path: str) -> None:
    with open(path, "w", encoding="utf-8") as f:
        json.dump(table.to_dict(), f, indent=2, sort_keys=True)
        f.write("\n")


_TABLE_CACHE: Optional[TileTable] = None


def active_table() -> TileTable:
    global _TABLE_CACHE
    if _TABLE_CACHE is None:
        _TABLE_CACHE = load_table()
    return _TABLE_CACHE


@contextlib.contextmanager
def table_override(table) -> Iterator[TileTable]:
    """Swap the active table for a test or an experiment: accepts a
    :class:`TileTable` or a path."""
    global _TABLE_CACHE
    prev = _TABLE_CACHE
    _TABLE_CACHE = table if isinstance(table, TileTable) else load_table(
        table)
    try:
        yield _TABLE_CACHE
    finally:
        _TABLE_CACHE = prev


# ---------------------------------------------------------------------------
# Resolution: kernel key + shape class -> TileConfig
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class TileConfig:
    """One resolved tile choice plus where it came from (``table``: a
    committed row, ``fallback``: the analytic choice, ``override``: the
    caller pinned it)."""

    kernel: str
    block_q: int = 0
    block_k: int = 0
    split_tokens: int = 0
    source: str = "fallback"

    def as_dict(self) -> Dict[str, Any]:
        d: Dict[str, Any] = {"kernel": self.kernel, "source": self.source}
        if self.kernel == "paged_attn":
            d["split_tokens"] = self.split_tokens
        else:
            d["block_q"] = self.block_q
            d["block_k"] = self.block_k
        return d


_RECORDERS: List[List[Dict[str, Any]]] = []


@contextlib.contextmanager
def record_resolutions() -> Iterator[List[Dict[str, Any]]]:
    """Collect every tile resolution made inside the block."""
    buf: List[Dict[str, Any]] = []
    _RECORDERS.append(buf)
    try:
        yield buf
    finally:
        _RECORDERS.remove(buf)


def _record(cfg: TileConfig, shape: Dict[str, Any]) -> TileConfig:
    if _RECORDERS:
        d = cfg.as_dict()
        d["shape"] = shape
        for buf in _RECORDERS:
            buf.append(d)
    return cfg


def summarize_resolutions(buf: List[Dict[str, Any]]) -> List[Dict[str, Any]]:
    """Order-preserving dedup of a recorder buffer."""
    seen, out = set(), []
    for d in buf:
        key = (d["kernel"], d.get("block_q"), d.get("block_k"),
               d.get("split_tokens"), d["source"])
        if key in seen:
            continue
        seen.add(key)
        out.append(d)
    return out


def resolve_flash(kernel: str, *, seq: int, head_dim: int, n_heads: int,
                  n_kv_heads: int, dtype: Any, causal: bool,
                  block_q: Optional[int] = None,
                  block_k: Optional[int] = None,
                  batch: Optional[int] = None,
                  sms: Optional[int] = None,
                  generation: Optional[str] = None) -> TileConfig:
    """Resolve one flash kernel's ``(block_q, block_k)``.

    Explicit knobs are recorded untouched (``source="override"``; a
    partial override pins one knob and resolves the other); otherwise
    the table's most-specific entry; otherwise the fallback, the tile
    the kernel runs (:func:`flash_tile`; ``batch`` and the card's
    ``sms`` decide the forward's rows). Whatever is recorded, the
    kernels run :func:`flash_tile`'s tile and mask a ragged last tile,
    so no value is fitted to ``seq`` and none is refused.
    """
    if kernel not in KERNELS or kernel == "paged_attn":
        raise ValueError(f"not a flash kernel key: {kernel!r}")
    shape = {"seq": seq, "head_dim": head_dim, "n_heads": n_heads,
             "n_kv_heads": n_kv_heads, "dtype": dtype_name(dtype),
             "causal": bool(causal)}
    if block_q is not None and block_k is not None:
        return _record(TileConfig(kernel, int(block_q), int(block_k),
                                  source="override"), shape)
    gen = generation or backend_generation()
    entry = active_table().lookup(
        kernel, seq=seq, head_dim=head_dim, n_heads=n_heads,
        n_kv_heads=n_kv_heads, dtype=dtype, causal=causal, generation=gen)
    if entry is not None:
        bq, bk, source = entry["block_q"], entry["block_k"], "table"
    else:
        batch_heads = None if batch is None else batch * n_heads
        (bq, bk), source = flash_tile(
            kernel, head_dim, dtype, batch_heads=batch_heads, seq=seq,
            sms=sms), "fallback"
    if block_q is not None:
        bq, source = int(block_q), "override"
    if block_k is not None:
        bk, source = int(block_k), "override"
    return _record(TileConfig(kernel, bq, bk, source=source), shape)


def resolve_paged(*, max_seq_len: int, page_size: int, n_heads: int,
                  n_kv_heads: int, head_dim: int, dtype: Any,
                  split_tokens: Optional[int] = None,
                  generation: Optional[str] = None) -> TileConfig:
    """Resolve the paged decode kernel's ``split_tokens``.

    Same precedence as the flash path. A table entry whose split is not
    a whole number of THIS shape's pages (a row that leaves
    ``page_size`` open) degrades to the fallback rather than raising.
    The fallback is ``SPLIT_TOKENS``; the wrapper halves its pages while
    the block would pass the shared-memory limit.
    """
    shape = {"max_seq_len": max_seq_len, "page_size": page_size,
             "n_heads": n_heads, "n_kv_heads": n_kv_heads,
             "head_dim": head_dim, "dtype": dtype_name(dtype)}
    if split_tokens is not None:
        return _record(TileConfig("paged_attn",
                                  split_tokens=int(split_tokens),
                                  source="override"), shape)
    gen = generation or backend_generation()
    entry = active_table().lookup(
        "paged_attn", seq=max_seq_len, head_dim=head_dim,
        n_heads=n_heads, n_kv_heads=n_kv_heads, dtype=dtype, causal=True,
        generation=gen, page_size=page_size)
    st, source = SPLIT_TOKENS, "fallback"
    if entry is not None:
        st, source = int(entry["split_tokens"]), "table"
        if st % page_size:
            st, source = SPLIT_TOKENS, "fallback"
    return _record(TileConfig("paged_attn", split_tokens=st, source=source),
                   shape)
