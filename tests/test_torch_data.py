"""The port's input pipeline against the JAX package's, on the CPU: shard
IO, the Python twin batch for batch, the native batcher's epochs, the
refusals, and the device feed's length and order."""

import numpy as np
import pytest
import torch

from kubeflow_tpu import data as ref
from kubeflow_tpu_torch import data
from kubeflow_tpu_torch.data import loader as L


def _records(n, record_len=4):
    """Record i carries its id in slot 0 (coverage bookkeeping)."""
    out = np.zeros((n, record_len), np.float32)
    out[:, 0] = np.arange(n)
    out[:, 1:] = np.random.default_rng(0).normal(
        size=(n, record_len - 1)).astype(np.float32)
    return out


def test_shard_files_are_the_reference_format(tmp_path):
    """Shards written by either package read back in both, record for
    record, under the reference's file names."""
    recs = _records(100, 8)
    files = data.write_shards(str(tmp_path / "port"), recs, shards=3)
    want = ref.write_shards(str(tmp_path / "ref"), recs, shards=3)
    assert [f.rsplit("/", 1)[1] for f in files] == [
        f.rsplit("/", 1)[1] for f in want]
    for src in ("port", "ref"):
        for reader in (data.read_shards, ref.read_shards):
            np.testing.assert_array_equal(reader(str(tmp_path / src), 8),
                                          recs)
    assert data.shard_path("/x", 7) == "/x/shard-00007.f32"


def test_read_shards_errors_are_the_reference(tmp_path):
    for reader in (data.read_shards, ref.read_shards):
        with pytest.raises(FileNotFoundError, match="no .f32 shards"):
            reader(str(tmp_path), 4)
    data.write_shards(str(tmp_path), _records(10, 4))
    for reader in (data.read_shards, ref.read_shards):
        with pytest.raises(ValueError,
                           match="40 floats not divisible by record_len=3"):
            reader(str(tmp_path), 3)
    with pytest.raises(ValueError, match="records must be"):
        data.write_shards(str(tmp_path), np.zeros(4, np.float32))


@pytest.mark.parametrize("seed", [0, 7])
def test_py_loader_batches_equal_the_reference(seed):
    """Three epochs of 40 records in batches of 16 (drop-remainder: 2 a
    epoch), batch for batch and epoch for epoch."""
    recs = _records(40)
    ours = data.PyDataLoader(recs, batch=16, seed=seed)
    theirs = ref.PyDataLoader(recs, batch=16, seed=seed)
    epochs = []
    for _ in range(6):
        (a, ea), (b, eb) = ours.next(), theirs.next()
        np.testing.assert_array_equal(a, b)
        assert ea == eb
        epochs.append(ea)
    assert epochs == [0, 0, 1, 1, 2, 2]


def test_native_loader_covers_each_epoch_exactly_once():
    recs = _records(128)
    loader = data.DataLoader(recs, batch=16, seed=3, n_threads=2,
                             pool_size=4)
    assert loader.native, "the native loader must build with g++"
    by_epoch = {}
    # read generously: batches may interleave across the epoch boundary
    for _ in range(40):
        batch, epoch = loader.next()
        by_epoch.setdefault(epoch, []).extend(
            batch[:, 0].astype(int).tolist())
        if len(by_epoch.get(0, [])) == 128 and len(
                by_epoch.get(1, [])) >= 128:
            break
    loader.close()
    assert sorted(by_epoch[0]) == list(range(128))
    assert sorted(by_epoch[1][:128]) == list(range(128))


def test_native_batches_are_real_records_and_the_reference_order():
    """With one producer thread the order is deterministic: the port's
    copy of the batcher gives the reference's batches."""
    recs = _records(64, 6)
    with data.DataLoader(recs, batch=8, seed=1, n_threads=1) as ours, \
            ref.DataLoader(recs, batch=8, seed=1, n_threads=1) as theirs:
        assert ours.native and theirs.native
        for _ in range(10):
            (a, ea), (b, eb) = ours.next(), theirs.next()
            assert a.shape == (8, 6) and ea == eb
            np.testing.assert_array_equal(a, b)
            for row in a:
                np.testing.assert_array_equal(row, recs[int(row[0])])


def test_loader_falls_back_without_the_library(monkeypatch):
    monkeypatch.setattr(L, "load_library", lambda: None)
    loader = L.DataLoader(_records(16), batch=4, seed=5)
    assert not loader.native and loader.ready() == 0
    batch, epoch = loader.next()
    np.testing.assert_array_equal(
        batch, data.PyDataLoader(_records(16), batch=4, seed=5).next()[0])
    assert epoch == 0


@pytest.mark.parametrize("cls", ["DataLoader", "PyDataLoader"])
def test_loaders_reject_an_oversized_batch_as_the_reference(cls):
    recs = _records(8)
    msg = "batch 16 must be in \\[1, 8\\]"
    with pytest.raises(ValueError, match=msg):
        getattr(data, cls)(recs, batch=16)
    with pytest.raises(ValueError, match=msg):
        getattr(ref, cls)(recs, batch=16)


def test_native_loader_rejects_bad_pools():
    with pytest.raises(ValueError, match="n_threads >= 1"):
        data.DataLoader(_records(8), batch=4, n_threads=0)
    with pytest.raises(ValueError, match="records must be"):
        data.DataLoader(np.zeros(8, np.float32), batch=4)


def test_device_feed_yields_exactly_steps_batches_in_order():
    """``steps`` batches and no more are taken from the loader, each the
    loader's next batch, reshaped, on the device; a second feed goes on
    at the batch after them; ``steps=0`` yields nothing."""
    recs = _records(64, 12)
    loader = data.PyDataLoader(recs, batch=16, seed=0)
    got = list(data.device_feed(loader, "cpu", reshape=(16, 3, 4),
                                steps=3))
    check = data.PyDataLoader(recs, batch=16, seed=0)
    assert len(got) == 3
    for t in got:
        assert isinstance(t, torch.Tensor) and t.shape == (16, 3, 4)
        np.testing.assert_array_equal(t.numpy().reshape(16, 12),
                                      check.next()[0])
    np.testing.assert_array_equal(
        next(data.device_feed(loader, "cpu", steps=1)).numpy(),
        check.next()[0])
    assert list(data.device_feed(loader, "cpu", steps=0)) == []


def test_device_feed_transform_splits_and_casts_on_the_host():
    """A transform returning a tuple lands as a tuple of tensors: bf16
    pixels and int32 labels, as the ResNet entry point feeds them."""
    recs = _records(32, 13)

    def split(rec):
        return (torch.from_numpy(rec[:, 1:].copy()).reshape(8, 2, 2, 3)
                .to(torch.bfloat16),
                torch.from_numpy(rec[:, 0].astype(np.int32)))

    feed = data.device_feed(data.PyDataLoader(recs, batch=8, seed=2), "cpu",
                            transform=split, steps=2)
    want = data.PyDataLoader(recs, batch=8, seed=2)
    for pixels, labels in feed:
        rec = want.next()[0]
        assert pixels.dtype == torch.bfloat16 and labels.dtype == torch.int32
        np.testing.assert_array_equal(labels.numpy(), rec[:, 0])
        np.testing.assert_array_equal(
            pixels.float().numpy().reshape(8, 12),
            torch.from_numpy(rec[:, 1:].copy()).to(torch.bfloat16)
            .float().numpy())


class _FakeMesh:
    """What the feed reads of a mesh: axis names and sizes, this rank's
    coordinate, the device type (dp = 2, this rank at dp index 1)."""

    mesh_dim_names = ("dcn", "dp", "pp", "tp")
    device_type = "cpu"

    def size(self, i):
        return (1, 2, 1, 1)[i]

    def get_coordinate(self):
        return [0, 1, 0, 0]


def test_device_feed_over_a_mesh_hands_each_rank_its_rows():
    """``device_feed(loader, mesh)``, as the reference's takes the mesh:
    each leaf is this rank's rows of the global batch (the second half at
    dp index 1 of 2), wrapped as ``RankRows`` so the step over the mesh
    takes them as they are; a global batch the ranks do not divide is
    refused."""
    from kubeflow_tpu_torch.parallel.mesh import RankRows
    from kubeflow_tpu_torch.train.trainer import _my_rows

    recs = _records(32, 13)

    def split(rec):
        return (torch.from_numpy(rec[:, 1:].copy()),
                torch.from_numpy(rec[:, 0].astype(np.int32)))

    mesh = _FakeMesh()
    want = data.PyDataLoader(recs, batch=8, seed=2)
    for pixels, labels in data.device_feed(
            data.PyDataLoader(recs, batch=8, seed=2), mesh, transform=split,
            steps=2):
        rec = want.next()[0][4:]
        assert isinstance(pixels, RankRows) and isinstance(labels, RankRows)
        np.testing.assert_array_equal(pixels.rows.numpy(), rec[:, 1:])
        np.testing.assert_array_equal(labels.rows.numpy(), rec[:, 0])
        assert _my_rows(pixels, mesh, ("dcn", "dp")) is pixels.rows
    with pytest.raises(ValueError, match="does not divide over 2"):
        next(data.device_feed(data.PyDataLoader(recs, batch=7), mesh,
                              steps=1))
