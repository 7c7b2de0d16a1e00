"""The port's data plane against the JAX package's: the same MultiSlot
text files, schema and shuffle seed give byte-identical packed batches
(ids, mask, floats) and the same SparseLayout.segment_ids."""

import gzip

import numpy as np
import pytest

from paddlebox_tpu.data import DataFeedSchema as JaxSchema
from paddlebox_tpu.data import SlotDataset as JaxDataset
from paddlebox_tpu.data.slot_record import SparseLayout as JaxLayout

from paddlebox_tpu_torch.data import DataFeedSchema, SlotDataset
from paddlebox_tpu_torch.data.parser import format_multislot_example
from paddlebox_tpu_torch.data.slot_record import SparseLayout

S, F, L = 4, 3, 3


def _write_files(tmp_path, schema, n_files=3, lines=40, seed=0):
    rng = np.random.default_rng(seed)
    paths = []
    for f in range(n_files):
        rows = []
        for _ in range(lines):
            vals = [("label", [int(rng.random() < 0.3)])]
            vals += [(f"dense_{i}", [float(np.float32(rng.normal()))])
                     for i in range(F)]
            # 0..L+1 ids per slot: empty slots and truncation both occur;
            # signs span the full uint64 range
            vals += [(f"slot_{i}",
                      rng.integers(0, 1 << 63, rng.integers(0, L + 2),
                                   dtype=np.uint64).tolist()
                      + ([(1 << 64) - 5] if rng.random() < 0.1 else []))
                     for i in range(S)]
            rows.append(format_multislot_example(vals, schema))
        path = tmp_path / (f"part-{f}" + (".gz" if f == 0 else ""))
        text = "\n".join(rows) + "\n"
        if f == 0:
            with gzip.open(path, "wt") as fh:
                fh.write(text)
        else:
            path.write_text(text)
        paths.append(str(path))
    return paths


@pytest.mark.parametrize("shuffle", ["none", "global", "local"])
def test_packed_batches_byte_identical(tmp_path, shuffle):
    schema = DataFeedSchema.ctr(num_sparse=S, num_float=F, max_len=L,
                                batch_size=16)
    jschema = JaxSchema.ctr(num_sparse=S, num_float=F, max_len=L,
                            batch_size=16)
    files = _write_files(tmp_path, schema)
    ours, ref = SlotDataset(schema, seed=11), JaxDataset(jschema, seed=11)
    for ds in (ours, ref):
        ds.set_filelist(files)
        ds.load_into_memory(global_shuffle=shuffle == "global")
        if shuffle == "local":
            ds.local_shuffle()
    assert ours.num_examples == ref.num_examples == 120
    np.testing.assert_array_equal(ours.unique_keys(), ref.unique_keys())
    got = list(ours.batches(16, drop_last=False))
    want = list(ref.batches(16, drop_last=False))
    assert len(got) == len(want) == 8
    for g, w in zip(got, want):
        for name in ("ids", "mask", "floats"):
            a, b = getattr(g, name), getattr(w, name)
            assert a.dtype == b.dtype and a.shape == b.shape, name
            assert a.tobytes() == b.tobytes(), name
    np.testing.assert_array_equal(SparseLayout.from_schema(schema).segment_ids,
                                  JaxLayout.from_schema(jschema).segment_ids)


def test_malformed_line_skipped(tmp_path):
    schema = DataFeedSchema.ctr(num_sparse=1, num_float=0)
    p = tmp_path / "bad"
    p.write_text("1 1 2 7 8\n1 0 5 1 2\n1 1 1 9\n")   # line 2 is torn
    ds = SlotDataset(schema)
    ds.set_filelist([str(p)])
    with pytest.warns(UserWarning, match="malformed"):
        ds.load_into_memory(global_shuffle=False)
    assert ds.num_examples == 2
