"""The port's tile table (``kubeflow_tpu_torch/ops/autotune.py``) against
the reference's ``kubeflow_tpu/ops/autotune.py``.

Mirrors ``tests/test_autotune.py``: seq buckets, ``fit_block``, dtype
names and entry keys equal the reference's; ``TileTable.lookup`` picks
the same row for the same entries and queries; overrides, partial
overrides and the loader's reject-with-warning path behave as there.
Then Hopper's legality in place of the VMEM estimate: a flash row only
at the tile its kernel is compiled for (64 x 64, or the bf16 D <= 64
wgmma tiles), a paged row's split a whole number of
pages whose block fits the shared-memory limit, wildcards checked at the
strictest shape; the committed ``sm_90`` rows reproduce the wrapper's
analytic choices; and the paged wrapper's split resolves through the
table. The last tests guard a difference by design: the reference's
flash path falls back to blockwise attention (or raises with
``kv_len``) where no tile of 16 or more divides the sequence; the
port's kernels mask a ragged tile and always take flash.
"""

import json
import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kubeflow_tpu.ops import autotune as jat
from kubeflow_tpu_torch.ops import autotune as at
from kubeflow_tpu_torch.ops import paged_attention as pa

LM_SHAPE = dict(head_dim=64, n_heads=16, n_kv_heads=16,
                dtype=torch.bfloat16, causal=True)
SERVING = dict(max_seq_len=2048, page_size=64, n_heads=16, n_kv_heads=16,
               head_dim=64)


def _flash_row(**kw):
    row = {"kernel": "flash_fwd", "seq_bucket": 8192, "head_dim": 64,
           "n_heads": None, "n_kv_heads": None, "dtype": "bfloat16",
           "causal": True, "generation": "*", "block_q": 64, "block_k": 64}
    row.update(kw)
    return row


def _paged_row(**kw):
    row = {"kernel": "paged_attn", "seq_bucket": None, "head_dim": None,
           "n_heads": None, "n_kv_heads": None, "page_size": None,
           "dtype": "*", "causal": None, "generation": "*",
           "split_tokens": 128}
    row.update(kw)
    return row


class TestVocabulary:
    @pytest.mark.parametrize("seq", [1, 127, 128, 129, 512, 513, 6144,
                                     8192, 8193])
    def test_seq_bucket_matches_reference(self, seq):
        assert at.seq_bucket(seq) == jat.seq_bucket(seq)

    @pytest.mark.parametrize("seq,block", [(8192, 1024), (6144, 1024),
                                           (60, 16), (64, 4096), (17, 64),
                                           (1031, 1024)])
    def test_fit_block_matches_reference(self, seq, block):
        assert at.fit_block(seq, block) == jat.fit_block(seq, block)

    def test_dtype_name(self):
        assert at.dtype_name(torch.bfloat16) == "bfloat16"
        assert at.dtype_name(torch.float32) == jat.dtype_name(jnp.float32)
        assert at.dtype_name(np.dtype("float32")) == "float32"
        assert at.dtype_name("int8") == "int8"

    @pytest.mark.parametrize("entry", [
        _flash_row(), _flash_row(causal=False, generation="sm_90"),
        _paged_row(), _paged_row(head_dim=64, n_heads=16, n_kv_heads=4,
                                 page_size=64, dtype="float32")],
        ids=["flash", "flash-sm90", "paged-wild", "paged-pinned"])
    def test_entry_key_matches_reference(self, entry):
        assert at.entry_key(entry) == jat.entry_key(entry)

    def test_generation_on_the_cpu(self):
        assert at.backend_generation(torch.device("cpu")) == "cpu"
        if not torch.cuda.is_available():
            assert at.backend_generation() == "cpu"


class TestLookupPrecedence:
    """The same entries and queries through both tables pick the same
    row (tables built directly: lookup does not validate)."""

    ENTRIES = [
        _flash_row(),
        _flash_row(generation="sm_90"),
        _flash_row(head_dim=None),
        _flash_row(seq_bucket=512, causal=False, n_heads=12),
        _flash_row(seq_bucket=512, causal=False),
        _paged_row(),
        _paged_row(page_size=64, dtype="bfloat16"),
        _paged_row(page_size=64, dtype="bfloat16", n_heads=16,
                   n_kv_heads=16, head_dim=64, generation="sm_90"),
    ]
    QUERIES = [
        ("flash_fwd", dict(seq=8192, head_dim=64, n_heads=16,
                           n_kv_heads=16, dtype="bfloat16", causal=True,
                           generation="sm_90")),
        ("flash_fwd", dict(seq=8000, head_dim=64, n_heads=16,
                           n_kv_heads=16, dtype="bfloat16", causal=True,
                           generation="cpu")),
        ("flash_fwd", dict(seq=8192, head_dim=128, n_heads=8, n_kv_heads=8,
                           dtype="bfloat16", causal=True, generation="cpu")),
        ("flash_fwd", dict(seq=512, head_dim=64, n_heads=12, n_kv_heads=12,
                           dtype="bfloat16", causal=False,
                           generation="cpu")),
        ("flash_fwd", dict(seq=512, head_dim=64, n_heads=16, n_kv_heads=16,
                           dtype="bfloat16", causal=False,
                           generation="cpu")),
        ("flash_fwd", dict(seq=4096, head_dim=64, n_heads=16,
                           n_kv_heads=16, dtype="float32", causal=True,
                           generation="cpu")),
        ("paged_attn", dict(seq=2048, head_dim=64, n_heads=16,
                            n_kv_heads=16, dtype="bfloat16", causal=True,
                            generation="sm_90", page_size=64)),
        ("paged_attn", dict(seq=2048, head_dim=64, n_heads=16,
                            n_kv_heads=16, dtype="bfloat16", causal=True,
                            generation="cpu", page_size=64)),
        ("paged_attn", dict(seq=2048, head_dim=96, n_heads=8, n_kv_heads=2,
                            dtype="float32", causal=True, generation="cpu",
                            page_size=16)),
    ]

    @pytest.mark.parametrize("kernel,query", QUERIES,
                             ids=[f"{k}-{i}" for i, (k, _) in
                                  enumerate(QUERIES)])
    def test_same_row_as_reference(self, kernel, query):
        mine = at.TileTable(self.ENTRIES, []).lookup(kernel, **query)
        ref = jat.TileTable(self.ENTRIES, []).lookup(kernel, **query)
        assert mine is ref

    def test_generation_pinned_row_outranks_wildcard(self):
        entries = [_flash_row(), _flash_row(generation="sm_90",
                                            provenance="card")]
        got = at.TileTable(entries, []).lookup(
            "flash_fwd", seq=8192, head_dim=64, n_heads=16, n_kv_heads=16,
            dtype=torch.bfloat16, causal=True, generation="sm_90")
        assert got["provenance"] == "card"


class TestResolution:
    @pytest.mark.parametrize("kernel", ["flash_fwd", "flash_bwd_dq",
                                        "flash_bwd_dkv"])
    @pytest.mark.parametrize("seq,n_heads,causal", [(8192, 16, True),
                                                    (512, 12, True),
                                                    (512, 12, False)])
    def test_phase_shapes_resolve_from_the_table_on_sm90(self, kernel, seq,
                                                         n_heads, causal):
        cfg = at.resolve_flash(kernel, seq=seq, head_dim=64,
                               n_heads=n_heads, n_kv_heads=n_heads,
                               dtype=torch.bfloat16, causal=causal,
                               generation="sm_90")
        want = {"flash_fwd": (192, 64), "flash_bwd_dq": (64, 128),
                "flash_bwd_dkv": (64, 128)}[kernel]
        # the forward's rows are the grid's (TestForwardRows): it has no
        # row, and without a batch the fallback is its 192
        source = "fallback" if kernel == "flash_fwd" else "table"
        assert (cfg.source, cfg.block_q, cfg.block_k) == (source, *want)

    def test_uncovered_shape_falls_back_to_the_compiled_tile(self):
        cfg = at.resolve_flash("flash_fwd", seq=4096, head_dim=128,
                               n_heads=8, n_kv_heads=8, dtype=torch.float32,
                               causal=True, generation="sm_90")
        assert (cfg.source, cfg.block_q, cfg.block_k) == ("fallback", 64, 64)

    def test_reference_knobs_are_an_override_never_a_refusal(self):
        """A reference export's TPU tiles (1024 edges) resolve as an
        override: recorded, not fitted, not refused."""
        cfg = at.resolve_flash("flash_fwd", seq=8192, block_q=1024,
                               block_k=1024, generation="sm_90", **LM_SHAPE)
        ref = jat.resolve_flash("flash_fwd", seq=8192, block_q=1024,
                                block_k=1024, head_dim=64, n_heads=16,
                                n_kv_heads=16, dtype=jnp.bfloat16,
                                causal=True)
        assert (cfg.source, cfg.block_q, cfg.block_k) == (
            ref.source, ref.block_q, ref.block_k)

    def test_partial_override_resolves_other_knob(self):
        cfg = at.resolve_flash("flash_fwd", seq=8192, block_q=256,
                               generation="sm_90", **LM_SHAPE)
        assert cfg.source == "override"
        assert (cfg.block_q, cfg.block_k) == (256, 64)

    def test_paged_serving_shape_resolves_from_the_table(self):
        for dtype in (torch.bfloat16, torch.float32):
            cfg = at.resolve_paged(dtype=dtype, generation="sm_90",
                                   **SERVING)
            assert (cfg.split_tokens, cfg.source) == (at.SPLIT_TOKENS,
                                                      "table")

    def test_paged_fallback_is_the_analytic_split(self):
        with at.table_override(at.TileTable([], [])):
            cfg = at.resolve_paged(dtype=torch.bfloat16, generation="sm_90",
                                   **SERVING)
        assert (cfg.split_tokens, cfg.source) == (at.SPLIT_TOKENS,
                                                  "fallback")

    def test_paged_override_wins(self):
        cfg = at.resolve_paged(dtype=torch.bfloat16, split_tokens=256,
                               generation="sm_90", **SERVING)
        assert (cfg.split_tokens, cfg.source) == (256, "override")

    def test_paged_row_not_whole_pages_of_this_shape_degrades(self):
        """A row legal where it leaves page_size open, but not a whole
        number of THIS shape's pages, degrades to the fallback."""
        table = at.TileTable([_paged_row(split_tokens=96)], [])
        with at.table_override(table):
            cfg = at.resolve_paged(dtype=torch.bfloat16, generation="sm_90",
                                   **SERVING)
        assert (cfg.split_tokens, cfg.source) == (at.SPLIT_TOKENS,
                                                  "fallback")


class TestHopperLegality:
    @pytest.mark.parametrize("bq,bk", [(128, 64), (64, 128), (1024, 1024),
                                       (32, 32)])
    def test_flash_row_only_at_the_compiled_tile(self, bq, bk):
        """The f32 forward (the FMA kernel) runs 64 x 64 and nothing
        else; the bf16 D = 64 forward's own tile is held in
        ``TestBackwardTiles``."""
        errs = at.validate_entry(_flash_row(dtype="float32", block_q=bq,
                                            block_k=bk))
        assert any("64 x 64" in e for e in errs)
        assert at.validate_entry(_flash_row(dtype="float32")) == []

    def test_flash_row_needs_a_seq_bucket(self):
        errs = at.validate_entry(_flash_row(seq_bucket=None))
        assert any("concrete seq_bucket" in e for e in errs)
        errs = at.validate_entry(_flash_row(seq_bucket=1000))
        assert any("power of two" in e for e in errs)

    @pytest.mark.parametrize("group,Dh,el,pps", [
        (1, 64, 2, 2), (1, 64, 4, 2), (16, 64, 2, 1), (4, 96, 2, 4),
        (8, 256, 4, 1), (1, 256, 2, 16), (2, 128, 4, 8)])
    def test_smem_formula_matches_the_c_source(self, group, Dh, el, pps):
        """The Python copy against hand-evaluated csrc
        ``kftpu_paged_decode_smem_bytes`` of the route at the shape. The
        TMA kernel (bf16, Dh 64, group <= 8): 1024 bytes of slack, 4
        stages of 64 K and 64 V rows of 128 bytes, 8 warps' partials of 8
        heads x 66 f32, 4 x 16 bytes of meta and 8 barriers, the list's
        5 x 1024 + 1 + 5 ints and 2048 page ids, whatever pps. The split kernel: the ring
        (4 x stage rows x Dh x el) or the cross-warp partials (4 warps x
        min(group, 8) heads x (Dh + 2) x 4), then pps ids."""
        if (el, Dh) == (2, 64) and group <= 8:
            want = (1024 + 4 * 2 * 64 * 128 + 8 * 8 * 66 * 4 + 4 * 16
                    + 8 * 8 + (5 * 1024 + 1 + 5 + 2048) * 4)
            assert at.paged_route(group, Dh, el) == at.PAGED_TMA_KERNEL
            assert at.paged_smem_bytes(group, Dh, el, pps) == want
            assert at.paged_smem_limit(group, Dh, el) == 232448
            return
        assert at.paged_route(group, Dh, el) == at.PAGED_SPLIT_KERNEL
        assert at.paged_smem_limit(group, Dh, el) == 48 * 1024
        chunks = Dh * el // 16
        slices = 2 if chunks > 32 else 1
        lanes = 1
        while lanes < -(-chunks // slices):
            lanes *= 2
        rows = 4 // slices * (128 // lanes)
        want = max(4 * rows * Dh * el, 4 * min(group, 8) * (Dh + 2) * 4)
        assert at.paged_smem_bytes(group, Dh, el, pps) == want + 4 * pps

    def test_paged_split_must_be_whole_pages(self):
        errs = at.validate_entry(_paged_row(page_size=64, split_tokens=96))
        assert any("whole number" in e for e in errs)

    def test_paged_split_past_shared_memory_rejected(self):
        """A block of 8 q heads at Dh 256, f32, needs 33 KB of partials
        before its page ids: 5,000 pages of ids pass 48 KB."""
        row = _paged_row(head_dim=256, n_heads=8, n_kv_heads=1,
                         page_size=1, dtype="float32", split_tokens=5000)
        errs = at.validate_entry(row)
        assert any("shared memory" in e for e in errs)
        row["split_tokens"] = 256
        assert at.validate_entry(row) == []

    def test_wildcards_checked_at_the_strictest_shape(self):
        assert at.paged_legality_point(_paged_row()) == (8, 256, 4, 128)
        pinned = _paged_row(head_dim=64, n_heads=16, n_kv_heads=16,
                            page_size=64, dtype="bfloat16")
        assert at.paged_legality_point(pinned) == (1, 64, 2, 2)

    def test_split_tokens_required(self):
        row = _paged_row()
        del row["split_tokens"]
        assert any("split_tokens" in e for e in at.validate_entry(row))


class TestBackwardTiles:
    """The legal tile is per kernel key: the bf16 D <= 64 wgmma tiles
    (the forward 192 or 64 q rows x 64 keys; dQ and dK/dV, one fused
    kernel, 64 q rows x 128 keys); the other kernels (f32, D = 128 and
    up) keep 64 x 64."""

    @pytest.mark.parametrize("kernel,tile", [("flash_bwd_dq", (64, 128)),
                                             ("flash_bwd_dkv", (64, 128)),
                                             ("flash_fwd", (192, 64))])
    @pytest.mark.parametrize("head_dim", [64, 32])
    def test_wgmma_tiles_are_legal(self, kernel, tile, head_dim):
        row = _flash_row(kernel=kernel, head_dim=head_dim, block_q=tile[0],
                         block_k=tile[1])
        assert at.validate_entry(row) == []
        assert at.flash_tile(kernel, head_dim, torch.bfloat16) == tile

    @pytest.mark.parametrize("kernel,tile", [("flash_bwd_dq", "64 x 128"),
                                             ("flash_bwd_dkv", "64 x 128"),
                                             ("flash_fwd", "192 x 64")])
    @pytest.mark.parametrize("bq,bk", [(128, 64), (128, 128)])
    def test_old_tile_refused_for_the_wgmma_kernels(self, kernel, tile, bq,
                                                    bk):
        errs = at.validate_entry(_flash_row(kernel=kernel, block_q=bq,
                                            block_k=bk))
        assert any(tile in e for e in errs)

    @pytest.mark.parametrize("kernel", ["flash_bwd_dq", "flash_bwd_dkv",
                                        "flash_fwd"])
    @pytest.mark.parametrize("head_dim,dtype", [(128, "bfloat16"),
                                                (256, "bfloat16"),
                                                (64, "float32"),
                                                (None, "float32")])
    def test_other_backward_kernels_keep_64_by_64(self, kernel, head_dim,
                                                  dtype):
        row = _flash_row(kernel=kernel, head_dim=head_dim, dtype=dtype)
        assert at.validate_entry(row) == []
        wgmma = _flash_row(kernel=kernel, head_dim=head_dim, dtype=dtype,
                           block_q=128, block_k=128)
        assert any("64 x 64" in e for e in at.validate_entry(wgmma))

    @pytest.mark.parametrize("kernel", ["flash_bwd_dq", "flash_bwd_dkv",
                                        "flash_fwd"])
    @pytest.mark.parametrize("field,value", [("head_dim", None),
                                             ("dtype", "*")])
    def test_a_row_open_where_the_kernel_changes_is_refused(self, kernel,
                                                            field, value):
        row = _flash_row(kernel=kernel, **{field: value})
        errs = at.validate_entry(row)
        assert any("pin head_dim and dtype" in e for e in errs)

    @pytest.mark.parametrize("kernel,tile,committed", [
        ("flash_fwd", (192, 64), "fallback"),
        ("flash_bwd_dq", (64, 128), "table"),
        ("flash_bwd_dkv", (64, 128), "table")])
    def test_resolve_flash_returns_what_the_kernel_runs(self, kernel, tile,
                                                        committed):
        """Without a row the fallback is the kernel's own tile, and the
        committed table agrees with it (the forward has no row: its rows
        are the grid's); an override is recorded as it is."""
        with at.table_override(at.TileTable([], [])):
            cfg = at.resolve_flash(kernel, seq=8192, generation="sm_90",
                                   **LM_SHAPE)
        assert (cfg.source, (cfg.block_q, cfg.block_k)) == ("fallback",
                                                           tile)
        cfg = at.resolve_flash(kernel, seq=8192, generation="sm_90",
                               **LM_SHAPE)
        assert (cfg.source, (cfg.block_q, cfg.block_k)) == (committed, tile)
        cfg = at.resolve_flash(kernel, seq=8192, block_q=64, block_k=64,
                               generation="sm_90", **LM_SHAPE)
        assert (cfg.source, cfg.block_q, cfg.block_k) == ("override", 64, 64)


class TestForwardRows:
    """The bf16 D <= 64 forward's rows an item, resolved per shape
    class: the committed table has no row for it, and the fallback
    takes the tile whose grid ends first on the card's SMs
    (``forward_rounds``, here an H100 SXM's 132): 64 rows where the
    192-row tile's last round would leave SMs idle. Without the SM count
    (no card) it is the 192-row tile."""

    # (batch, seq, heads, causal): the LM step, BERT-base, :predict's
    # two shapes, the BERT entry point's default, a short single request
    SHAPES = {"lm": (2, 8192, 16, True), "bert": (16, 512, 12, False),
              "predict_b8": (8, 512, 12, False),
              "predict_b1": (1, 128, 12, False),
              "bert_entry": (8, 128, 12, False),
              "one_request": (1, 512, 12, True)}
    # (on 132 SMs, without a card)
    ROWS = {"lm": (192, 192), "bert": (192, 192), "predict_b8": (64, 192),
            "predict_b1": (64, 192), "bert_entry": (64, 192),
            "one_request": (64, 192)}

    @pytest.mark.parametrize("table", [True, False])
    @pytest.mark.parametrize("name", sorted(SHAPES))
    def test_rows_by_shape_class(self, name, table):
        """``resolve_flash`` records the rows the kernel runs
        (``flash_tile``), from the committed table and from none."""
        B, S, H, causal = self.SHAPES[name]
        committed = at.load_table(strict=True)
        for sms, rows in zip((132, None), self.ROWS[name]):
            tile = at.flash_tile("flash_fwd", 64, torch.bfloat16,
                                 batch_heads=B * H, seq=S, sms=sms)
            with at.table_override(committed if table
                                   else at.TileTable([], [])):
                cfg = at.resolve_flash(
                    "flash_fwd", seq=S, head_dim=64, n_heads=H, n_kv_heads=H,
                    dtype=torch.bfloat16, causal=causal, batch=B, sms=sms,
                    generation="sm_90")
            assert tile == (rows, 64)
            assert (cfg.block_q, cfg.block_k, cfg.source) == (
                rows, 64, "fallback")
            assert tile in at.flash_tiles("flash_fwd", 64, torch.bfloat16)

    @pytest.mark.parametrize("heads,seq,rows", [
        (96, 512, 64), (192, 512, 192), (1, 8192, 64), (32, 8192, 192),
        (2048, 128, 64), (29, 576, 64), (30, 576, 192)])
    def test_short_grid_edge(self, heads, seq, rows):
        """The fallback's rounds: at S = 512, 96 heads run 768 64-row
        items in 3 rounds against 288 192-row items in 3 x 1.15 (64
        rows), 192 heads 6 rounds against 5 x 1.15 (192); one head of
        8192 fills no round of either (64), 32 heads do (192); at S = 128
        a 192-row item is a third empty, so 64 rows win at any count; at
        S = 576, 29 heads: 261 items in 1 round against 87 in 1 x 1.15
        (64); 30 heads: 270 in 2 against 90 in 1 x 1.15 (192)."""
        assert at.FWD_ROUNDS == {192: (1, 1.15), 64: (2, 1.0)}
        tile = at.flash_tile("flash_fwd", 64, torch.bfloat16,
                             batch_heads=heads, seq=seq, sms=132)
        assert tile == (rows, 64)

    @pytest.mark.parametrize("head_dim,dtype", [(128, torch.bfloat16),
                                                (64, torch.float32)])
    def test_other_forwards_keep_one_tile(self, head_dim, dtype):
        """Off the wgmma route a short grid changes nothing: 64 x 64."""
        assert at.flash_tile("flash_fwd", head_dim, dtype, batch_heads=1,
                             seq=128, sms=132) == (64, 64)
        assert at.flash_tiles("flash_fwd", head_dim, dtype) == {(64, 64)}

    def test_both_rows_legal_and_the_old_stage_refused(self):
        for bq in (64, 192):
            assert at.validate_entry(_flash_row(block_q=bq,
                                                block_k=64)) == []
        errs = at.validate_entry(_flash_row(block_q=128, block_k=128))
        assert any("64 x 64 or 192 x 64" in e for e in errs)


class TestTableIO:
    def test_committed_table_is_legal_and_canonical(self, tmp_path):
        table = at.load_table(strict=True)
        assert table.entries and not table.rejected
        out = tmp_path / "t.json"
        at.save_table(table, str(out))
        assert at.load_table(str(out), strict=True).to_dict() == \
            table.to_dict()
        committed = json.load(open(at.DEFAULT_TABLE_PATH))
        assert committed == table.to_dict()
        for e in table.entries:
            assert e["generation"] == "sm_90" and "H100" in e["provenance"]

    def test_committed_paged_rows_reproduce_the_analytic_choice(self):
        """Each committed paged row's split is what the fallback gives
        at its shape: pps = SPLIT_TOKENS / page, halved past the limit of
        the route that runs there."""
        for e in at.load_table().entries:
            if e["kernel"] != "paged_attn":
                continue
            group, Dh, el, _ = at.paged_legality_point(e)
            pps = at.SPLIT_TOKENS // e["page_size"]
            while pps > 1 and at.paged_smem_bytes(group, Dh, el, pps) > \
                    at.paged_smem_limit(group, Dh, el):
                pps //= 2
            assert e["split_tokens"] // e["page_size"] == pps

    def test_illegal_entry_rejected_with_warning_then_fallback(self,
                                                               tmp_path):
        bad = {"version": 1, "entries": [_flash_row(generation="sm_90",
                                                    block_q=128,
                                                    block_k=64)]}
        path = tmp_path / "bad.json"
        path.write_text(json.dumps(bad))
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            table = at.load_table(str(path))
        assert not table.entries and len(table.rejected) == 1
        assert any("rejected" in str(w.message) for w in caught)
        with at.table_override(table):
            cfg = at.resolve_flash("flash_fwd", seq=8192,
                                   generation="sm_90", **LM_SHAPE)
        assert (cfg.source, cfg.block_q) == ("fallback", 192)

    def test_strict_load_raises_on_illegal(self, tmp_path):
        path = tmp_path / "bad.json"
        path.write_text(json.dumps({"entries": [_paged_row(
            page_size=64, split_tokens=100)]}))
        with pytest.raises(ValueError, match="whole number"):
            at.load_table(str(path), strict=True)

    def test_unreadable_table_never_fails_runtime(self, tmp_path):
        garbage = tmp_path / "garbage.json"
        garbage.write_text("{not json")
        directory = tmp_path / "dir.json"
        directory.mkdir()
        for path in (garbage, directory):
            with warnings.catch_warnings(record=True):
                warnings.simplefilter("always")
                table = at.load_table(str(path))
            assert table.entries == [] and table.rejected
        assert at.load_table(str(tmp_path / "missing.json")).entries == []
        with pytest.raises(FileNotFoundError):
            at.load_table(str(tmp_path / "missing.json"), strict=True)


class TestRecorder:
    def test_resolutions_recorded_with_source(self):
        with at.record_resolutions() as rec:
            at.resolve_flash("flash_bwd_dq", seq=8192, generation="sm_90",
                             **LM_SHAPE)
            at.resolve_flash("flash_fwd", seq=8192, block_q=128,
                             block_k=128, generation="sm_90", **LM_SHAPE)
            at.resolve_paged(dtype=torch.bfloat16, generation="sm_90",
                             **SERVING)
        summary = at.summarize_resolutions(rec)
        sources = {(d["kernel"], d["source"]) for d in summary}
        assert sources == {("flash_bwd_dq", "table"),
                           ("flash_fwd", "override"), ("paged_attn", "table")}

    def test_summarize_dedupes(self):
        with at.record_resolutions() as rec:
            for _ in range(3):
                at.resolve_flash("flash_fwd", seq=8192, generation="sm_90",
                                 **LM_SHAPE)
        assert len(rec) == 3
        assert len(at.summarize_resolutions(rec)) == 1

    def test_flash_attention_records_each_pass(self):
        """The port's ``flash_attention`` resolves its three kernel keys
        (forward, then dQ and dK/dV in the backward), the reference's
        knobs recorded as an override."""
        from kubeflow_tpu_torch.ops.attention import flash_attention

        q, k, v = (torch.randn(1, 32, 2, 16, requires_grad=True)
                   for _ in range(3))
        with at.record_resolutions() as rec:
            flash_attention(q, k, v, True, 512, 1024).sum().backward()
        assert [(d["kernel"], d["source"], d["block_q"], d["block_k"])
                for d in rec] == [
            ("flash_fwd", "override", 512, 1024),
            ("flash_bwd_dq", "override", 512, 1024),
            ("flash_bwd_dkv", "override", 512, 1024)]
        assert rec[0]["shape"]["seq"] == 32


class _SmemLib:
    """The wrapper's view of the library: its shared-memory formula."""

    @staticmethod
    def kftpu_paged_decode_smem_bytes(group, Dh, el, pps):
        return at.paged_smem_bytes(group, Dh, el, pps)


class TestPagedWrapperSplit:
    def _q(self, QH=16, Dh=64, dtype=torch.bfloat16):
        return torch.zeros(8, QH, Dh, dtype=dtype)

    def test_table_row_sets_the_pages_per_split(self):
        table = at.TileTable([_paged_row(split_tokens=256)], [])
        with at.table_override(table), at.record_resolutions() as rec:
            pps = pa._pages_per_split(_SmemLib, self._q(), 16, 64, 32)
        assert pps == 4
        assert [(d["split_tokens"], d["source"]) for d in rec] == [
            (256, "table")]
        assert rec[0]["shape"]["max_seq_len"] == 2048

    def test_fallback_is_the_analytic_choice(self):
        with at.table_override(at.TileTable([], [])):
            assert pa._pages_per_split(_SmemLib, self._q(), 16, 64, 32) == 2
            # page 16: 8 pages of ids, still within the limit
            assert pa._pages_per_split(_SmemLib, self._q(), 16, 16, 128) == 8

    def test_a_row_the_block_cannot_hold_raises(self):
        """A row is taken as it is, never replaced: one past the limit
        (kept out of a loaded table by validate_entry) raises."""
        table = at.TileTable([_paged_row(split_tokens=5000)], [])
        with at.table_override(table), pytest.raises(ValueError,
                                                     match="shared memory"):
            pa._pages_per_split(_SmemLib, self._q(8, 256, torch.float32),
                                1, 1, 5000)


class TestFitBlockFallbackByDesign:
    """The reference's flash path takes blockwise attention where
    ``fit_block(S, 1024) < 16`` and raises there with ``kv_len``; the
    port's kernels mask a ragged tile and take flash at every S (ROADMAP
    "Differences by design"). The answers agree all the same."""

    def _below_the_reference_tiles(self, S):
        assert jat.fit_block(S, jat.MAX_TILE_EDGE) < 16

    def test_short_sequence_runs_flash_and_matches_blockwise(self):
        from kubeflow_tpu.ops import attention as jatt
        from kubeflow_tpu_torch.ops.attention import flash_attention

        self._below_the_reference_tiles(8)
        rng = np.random.default_rng(0)
        q, k, v = (rng.standard_normal((2, 8, 2, 16)).astype(np.float32)
                   for _ in range(3))
        want = jatt.blockwise_attention(jnp.asarray(q), jnp.asarray(k),
                                        jnp.asarray(v), causal=True,
                                        block_k=1024)
        with at.record_resolutions() as rec:
            got = flash_attention(*(torch.from_numpy(a) for a in (q, k, v)))
        assert rec[0]["kernel"] == "flash_fwd"
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   atol=1e-5)

    def test_kv_len_at_a_short_sequence_runs_where_the_reference_raises(
            self):
        from kubeflow_tpu_torch.ops.attention import (
            flash_attention,
            reference_attention,
        )

        self._below_the_reference_tiles(8)
        q, k, v = (torch.randn(2, 8, 2, 16) for _ in range(3))
        kv_len = torch.tensor([8, 5], dtype=torch.int32)
        got = flash_attention(q, k, v, False, kv_len=kv_len)
        want = reference_attention(q, k, v, causal=False, kv_len=kv_len)
        torch.testing.assert_close(got, want, atol=1e-5, rtol=0)
