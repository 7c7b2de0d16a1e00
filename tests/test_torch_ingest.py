"""The port's data plane against the JAX package's, on the CPU: the native
and Python MultiSlot parsers, hashing, ``.pbar`` archives both ways,
pipe commands, parser plugins, the data generator, the in-memory
transforms and the streaming QueueDataset. The same inputs, made from a
numpy seed, go through both packages; "bit-exact" means identical arrays
(``tobytes``), dtypes included.

Mirrors the JAX-side cases of tests/test_native_parser.py,
test_archive.py, test_data_plane.py and test_queue_dataset.py.
"""

import gc
import gzip
import os
import sys
import threading
import warnings

import numpy as np
import pytest

from paddlebox_tpu.data import DataFeedSchema as JaxSchema
from paddlebox_tpu.data import QueueDataset as JaxQueue
from paddlebox_tpu.data import Slot as JaxSlot
from paddlebox_tpu.data import SlotDataset as JaxDataset
from paddlebox_tpu.data import SlotType as JaxSlotType
from paddlebox_tpu.data import archive as jax_archive
from paddlebox_tpu.data import parser as jax_parser
from paddlebox_tpu.data import reader as jax_reader
from paddlebox_tpu.native import slot_parser_binding as jax_native
from paddlebox_tpu.utils import hashing as jax_hashing

from paddlebox_tpu_torch.data import (Channel, DataFeedSchema, ParseStats,
                                      QueueDataset, Slot, SlotDataset,
                                      SlotType, archive, parser)
from paddlebox_tpu_torch.data.dataset import parse_threads_per_file
from paddlebox_tpu_torch.data.reader import read_file
from paddlebox_tpu_torch.native import slot_parser
from paddlebox_tpu_torch.utils import fs as fs_lib
from paddlebox_tpu_torch.utils import hashing

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# (name, type, max_len, is_used): a multi-width float slot, an unused
# sparse slot the parsers must step over, multi-hot sparse slots
SLOTS = [("label", "float", 1, True), ("dense", "float", 3, True),
         ("skip_me", "uint64", 5, False), ("s0", "uint64", 4, True),
         ("s1", "uint64", 2, True)]


def schemas(batch_size=8):
    def make(slot_cls, type_cls, schema_cls):
        return schema_cls([slot_cls(n, type_cls.FLOAT if t == "float"
                                    else type_cls.UINT64, max_len=w,
                                    is_used=u)
                           for n, t, w, u in SLOTS], batch_size=batch_size)
    return (make(Slot, SlotType, DataFeedSchema),
            make(JaxSlot, JaxSlotType, JaxSchema))


def make_lines(n, seed=0, with_ins_id=False, big=False):
    """MultiSlot lines in SLOTS order: 0..4 dense values against width 3
    (pads and truncations), 0..5 ids per sparse slot, signs over the
    whole uint64 range when ``big``."""
    rng = np.random.default_rng(seed)
    hi = (1 << 64) - 1 if big else (1 << 63) - 1
    lines = []
    for i in range(n):
        parts = [f"ins_{seed}_{i % 7}\t1" if with_ins_id else "1",
                 str(int(rng.integers(0, 2)))]
        ln = int(rng.integers(0, 5))
        parts.append(str(ln))
        parts.extend(f"{rng.random():.6f}" for _ in range(ln))
        for _slot in range(3):
            ln = int(rng.integers(0, 6))
            parts.append(str(ln))
            parts.extend(str(int(k)) for k in
                         rng.integers(0, hi, ln, dtype=np.uint64))
        lines.append(" ".join(parts))
    return lines


FIELDS = ("sparse_values", "sparse_offsets", "float_values")


def assert_records_identical(a, b):
    assert a.num == b.num
    for f in FIELDS:
        for x, y in zip(getattr(a, f), getattr(b, f), strict=True):
            assert x.dtype == y.dtype and x.tobytes() == y.tobytes(), f
    for f in ("ins_id", "search_id", "rank", "cmatch"):
        x, y = getattr(a, f), getattr(b, f)
        assert x.dtype == y.dtype and x.tobytes() == y.tobytes(), f


def assert_batches_identical(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.num == w.num
        for f in ("ids", "mask", "floats", "ins_id", "search_id", "rank",
                  "cmatch"):
            x, y = getattr(g, f), getattr(w, f)
            assert x.dtype == y.dtype and x.shape == y.shape, f
            assert x.tobytes() == y.tobytes(), f


def jax_parse(backend, buf, schema, with_ins_id):
    """The JAX package's parse of ``buf`` by ``backend``; its native
    library is the one its own tests build (make), else its Python
    parser, which its tests hold bit-equal to the native one."""
    if backend == "native" and jax_native.available():
        return jax_native.parse_buffer(buf, schema, with_ins_id=with_ins_id)
    return jax_parser._parse_python(buf.decode().splitlines(), schema,
                                    with_ins_id)


def port_parse(backend, buf, schema, with_ins_id, **kw):
    if backend == "native":
        return slot_parser.parse_buffer(buf, schema,
                                        with_ins_id=with_ins_id, **kw)
    return parser._parse_python(buf.decode().splitlines(), schema,
                                with_ins_id)


# ---------------------------------------------------------------------------
# parsers and hashing
# ---------------------------------------------------------------------------

def test_native_parser_builds_here():
    assert parser.is_native(), slot_parser.build_error()
    assert slot_parser.build_error() is None


@pytest.mark.parametrize("backend", ["native", "python"])
@pytest.mark.parametrize("case", ["plain", "ins_id", "crlf_blank",
                                  "u64_above_2_63"])
def test_parser_bit_exact_against_jax(backend, case):
    schema, jschema = schemas()
    with_ins_id = case == "ins_id"
    lines = make_lines(120, seed=1, with_ins_id=with_ins_id,
                       big=case == "u64_above_2_63")
    if case == "crlf_blank":
        buf = ("\n\n" + "\r\n".join(lines) + "\n\n").encode()
    else:
        buf = "\n".join(lines).encode()
    got = port_parse(backend, buf, schema, with_ins_id)
    want = jax_parse(backend, buf, jschema, with_ins_id)
    assert_records_identical(got, want)
    assert got.num == 120
    if with_ins_id:
        assert got.ins_id.any() and len(np.unique(got.ins_id)) == 7
    if case == "u64_above_2_63":
        # signs >= 2^63 are stored as their int64 bit patterns
        assert (np.concatenate(got.sparse_values) < 0).any()


def test_u64_extremes_wrap_identically():
    schema = DataFeedSchema([Slot("s", SlotType.UINT64, max_len=3)])
    jschema = JaxSchema([JaxSlot("s", JaxSlotType.UINT64, max_len=3)])
    line = "3 9223372036854775813 18446744073709551615 9223372036854775807"
    want = jax_parser._parse_python([line], jschema, False).sparse_values[0]
    for got in (parser._parse_python([line], schema, False),
                slot_parser.parse_buffer(line.encode(), schema)):
        assert got.sparse_values[0].tobytes() == want.tobytes()
    np.testing.assert_array_equal(
        want.view(np.uint64),
        [9223372036854775813, 18446744073709551615, 9223372036854775807])


@pytest.mark.parametrize("n_threads", [1, 3, 8])
def test_native_thread_count_does_not_change_the_result(n_threads):
    schema, _ = schemas()
    buf = "\n".join(make_lines(500, seed=4, with_ins_id=True)).encode()
    one = slot_parser.parse_buffer(buf, schema, True, n_threads=1)
    got = slot_parser.parse_buffer(buf, schema, True, n_threads=n_threads)
    assert_records_identical(got, one)


def test_native_parser_is_strict_and_names_the_line():
    schema, _ = schemas()
    with pytest.raises(ValueError, match="malformed"):
        slot_parser.parse_buffer(b"1 0 2 5\n", schema)
    with pytest.raises(ValueError, match="malformed"):
        slot_parser.parse_buffer(b"not a number\n", schema)
    good = "\n".join(make_lines(300, seed=7))
    with pytest.raises(ValueError, match=r"line 301"):
        slot_parser.parse_buffer((good + "\nbogus\n").encode(), schema,
                                 n_threads=4)


@pytest.mark.parametrize("entry", ["lines", "buffer"])
def test_malformed_lines_reparse_in_python_like_jax(entry):
    """The native parser raises on the torn line; the port re-parses in
    Python, skips it with a warning naming it and counts it — the JAX
    contract, bit-exact with the JAX package's result."""
    schema, jschema = schemas()
    lines = make_lines(20, seed=3, with_ins_id=True)
    lines.insert(5, "ins_x\t1 1 0 1 5")               # torn mid-slot
    lines.insert(9, "ins_y\t1 0 -1 0 0 0")            # negative length
    stats = ParseStats()
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        if entry == "lines":
            got = parser.parse_multislot_lines(iter(lines), schema, True,
                                               stats=stats)
            want = jax_parser.parse_multislot_lines(iter(lines), jschema,
                                                    True)
        else:
            buf = "\n".join(lines).encode()
            got = parser.parse_multislot_buffer(buf, schema, True,
                                                stats=stats)
            want = jax_parser.parse_multislot_buffer(buf, jschema, True)
    assert_records_identical(got, want)
    assert got.num == 20
    assert any("malformed MultiSlot line 6" in str(x.message) for x in w)
    assert stats.as_dict() == {"native": 0, "python": 1,
                               "native_rejects": 1, "parse_errors": 2}
    with pytest.raises(ValueError, match="every line was malformed"):
        parser.parse_multislot_lines(["1 1.0 2 11", "garbage"], schema)


def test_clean_parse_counts_native():
    schema, _ = schemas()
    stats = ParseStats()
    parser.parse_multislot_buffer("\n".join(make_lines(9)).encode(),
                                  schema, stats=stats)
    assert stats.native == 1 and stats.python == 0


def test_generator_not_consumed_without_native(monkeypatch):
    """With the library unavailable the Python parser gets the lines
    untouched (a one-shot generator must not arrive exhausted)."""
    monkeypatch.setattr(slot_parser, "get_lib", lambda: None)
    schema = DataFeedSchema([Slot("s", SlotType.UINT64, max_len=2)])
    stats = ParseStats()
    got = parser.parse_multislot_lines((x for x in ["1 5", "1 6"]), schema,
                                       stats=stats)
    assert got.num == 2 and stats.python == 1 and stats.native == 0
    assert slot_parser.parse_lines(iter(["1 5"]), schema) is None


@pytest.mark.parametrize("s", ["", "a", "ins_123", "ünicode-☃",
                               b"\x00\xff raw"])
def test_hash64_bit_exact(s):
    assert hashing.hash64(s) == jax_hashing.hash64(s)
    assert slot_parser.hash64_native(s) == jax_hashing.hash64(s)


def test_hash64_array_bit_exact():
    rng = np.random.default_rng(0)
    for a in (rng.integers(0, 1 << 64, 1000, dtype=np.uint64),
              rng.integers(-(1 << 63), (1 << 63) - 1, 1000, dtype=np.int64)):
        got, want = hashing.hash64_array(a), jax_hashing.hash64_array(a)
        assert got.dtype == want.dtype and got.tobytes() == want.tobytes()


# ---------------------------------------------------------------------------
# archives
# ---------------------------------------------------------------------------

def _records_pair(n=40, seed=5, with_ins_id=True):
    schema, jschema = schemas()
    buf = "\n".join(make_lines(n, seed=seed, with_ins_id=with_ins_id,
                               big=True)).encode()
    return (schema, jschema, port_parse("native", buf, schema, with_ins_id),
            jax_parse("native", buf, jschema, with_ins_id))


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_archive_bit_exact_both_ways(tmp_path, writer):
    schema, jschema, ours, ref = _records_pair()
    assert_records_identical(ours, ref)
    # the u64 ins_id column and signs >= 2^63 cross as they are
    assert ours.ins_id.dtype == np.uint64 and ours.ins_id.any()
    p_port, p_jax = str(tmp_path / "port.pbar"), str(tmp_path / "jax.pbar")
    archive.write_archive(p_port, ours)
    jax_archive.write_archive(p_jax, ref)
    with open(p_port, "rb") as a, open(p_jax, "rb") as b:
        assert a.read() == b.read()          # the same bytes on disk
    src = p_jax if writer == "jax" else p_port
    got = archive.read_archive(src, schema)
    want = jax_archive.read_archive(src, jschema)
    assert_records_identical(got, want)
    assert_records_identical(got, ours)


def test_archive_schema_and_width_mismatch_raise(tmp_path):
    schema, _, ours, _ = _records_pair(n=6)
    p = str(tmp_path / "x.pbar")
    archive.write_archive(p, ours)
    other = DataFeedSchema([Slot("label", SlotType.FLOAT, max_len=1),
                            Slot("zz", SlotType.UINT64, max_len=2)])
    with pytest.raises(ValueError, match="do not match schema"):
        archive.read_archive(p, other)
    wider = DataFeedSchema([s if s.name != "dense" else
                            Slot("dense", SlotType.FLOAT, max_len=4)
                            for s in schema.slots])
    with pytest.raises(ValueError, match="stale archive"):
        archive.read_archive(p, wider)
    with open(p, "r+b") as f:
        f.write(b"NOPE")
    with pytest.raises(ValueError, match="not a"):
        archive.read_archive(p, schema)


def _write_text_files(tmp_path, n_files=3, lines=24, seed=0,
                      with_ins_id=False, gz_first=True):
    paths = []
    for f in range(n_files):
        text = "\n".join(make_lines(lines, seed=seed + f,
                                    with_ins_id=with_ins_id)) + "\n"
        path = tmp_path / (f"part-{f}" + (".gz" if gz_first and f == 0
                                          else ""))
        if path.suffix == ".gz":
            with gzip.open(path, "wt") as fh:
                fh.write(text)
        else:
            path.write_text(text)
        paths.append(str(path))
    return paths


def _load_pair(files, configure=lambda ds: None, jconfigure=None,
               **load_kw):
    schema, jschema = schemas()
    ours, ref = SlotDataset(schema, seed=3), JaxDataset(jschema, seed=3)
    configure(ours)
    (jconfigure or configure)(ref)
    for ds in (ours, ref):
        ds.set_filelist(files)
        ds.load_into_memory(**load_kw)
    return ours, ref


def test_dataset_loads_archives_like_text(tmp_path):
    texts = _write_text_files(tmp_path, with_ins_id=True)
    schema, jschema = schemas()
    pbars = archive.archive_filelist(texts, schema, str(tmp_path / "arch"),
                                     with_ins_id=True)
    jpbars = jax_archive.archive_filelist(texts, jschema,
                                          str(tmp_path / "jarch"),
                                          with_ins_id=True)
    for a, b in zip(pbars, jpbars):
        assert os.path.basename(a) == os.path.basename(b)
        with open(a, "rb") as fa, open(b, "rb") as fb:
            assert fa.read() == fb.read()
    with pytest.raises(ValueError, match="collision"):
        archive.archive_filelist([texts[1], texts[1]], schema,
                                 str(tmp_path / "dup"), with_ins_id=True)

    def ins(ds):
        ds.with_ins_id = True
    txt, _ = _load_pair(texts, ins, global_shuffle=False)
    arc, ref = _load_pair(pbars, global_shuffle=False)
    assert_records_identical(arc.records, txt.records)
    assert_records_identical(arc.records, ref.records)
    assert arc.last_load_stats["native"] == 0       # no parse at all
    assert txt.last_load_stats["native"] == 3
    assert_batches_identical(list(arc.batches(8)), list(ref.batches(8)))


# ---------------------------------------------------------------------------
# pipe commands, plugins, the data generator
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shuffle", [False, True])
def test_pipe_command_bit_exact(tmp_path, shuffle):
    files = _write_text_files(tmp_path, gz_first=False)

    def cat(ds):
        ds.set_pipe_command("cat")
    ours, ref = _load_pair(files, cat, global_shuffle=shuffle)
    assert ours.num_examples == 72
    assert_records_identical(ours.records, ref.records)
    assert ours.last_load_stats["native"] == 3


def test_failing_pipe_command_raises(tmp_path):
    files = _write_text_files(tmp_path, n_files=1, gz_first=False)
    schema, _ = schemas()
    with pytest.raises(RuntimeError, match="exited 3"):
        read_file(files[0], schema, pipe_command="cat >/dev/null; exit 3")


def test_pipe_command_quotes_the_path(tmp_path):
    """A path with a space and shell metacharacters is one redirect
    target: the pipe reads the file's own bytes and runs nothing else."""
    files = _write_text_files(tmp_path, n_files=1, gz_first=False)
    odd = tmp_path / "part 0; touch pwned $(x)"
    os.rename(files[0], odd)
    schema, _ = schemas()
    got = read_file(str(odd), schema, pipe_command="cat")
    assert_records_identical(got, read_file(str(odd), schema))
    assert not (tmp_path / "pwned").exists()
    assert not os.path.exists("pwned")


def _plugin(lines, schema):
    return parser.parse_multislot_lines(list(lines), schema)


def _jax_plugin(lines, schema):
    return jax_parser.parse_multislot_lines(list(lines), schema)


def _unroll(batch):
    # a PV-unroll shape: every instance twice
    return batch.select(np.repeat(np.arange(batch.num), 2))


def test_parser_plugin_with_unroll_bit_exact(tmp_path):
    files = _write_text_files(tmp_path)
    calls = []

    def plugin(lines, schema):
        return _plugin(lines, schema)

    def unroll(batch):
        calls.append(batch.num)
        return _unroll(batch)

    plugin.unroll = unroll
    _jax_plugin.unroll = _unroll
    ours, ref = _load_pair(files, lambda ds: ds.set_parser_plugin(plugin),
                           lambda ds: ds.set_parser_plugin(_jax_plugin),
                           global_shuffle=True)
    assert calls == [72] and ours.num_examples == 144
    assert_records_identical(ours.records, ref.records)


def test_load_parser_plugin_by_module_path():
    from paddlebox_tpu_torch.data.reader import load_parser_plugin
    fn = load_parser_plugin(f"{__name__}:_plugin")
    assert fn is _plugin
    with pytest.raises(TypeError, match="not callable"):
        load_parser_plugin(f"{__name__}:REPO")


_GENERATOR = """
import sys
sys.path.insert(0, {repo!r})
from {pkg}.data import DataFeedSchema, Slot, SlotType
from {pkg}.data.data_generator import MultiSlotDataGenerator

SCHEMA = DataFeedSchema([Slot(n, SlotType.FLOAT if t == "float" else
                              SlotType.UINT64, max_len=w, is_used=u)
                         for n, t, w, u in {slots!r}])


class Gen(MultiSlotDataGenerator):
    # raw form: "<label>,<dense;...>,<ids;...>,<ids;...>,<ids;...>"
    def generate_sample(self, line):
        f = line.split(",")
        vals = [[] if not x else x.split(";") for x in f]
        yield [(s.name, v) for s, v in zip(SCHEMA.slots, vals)]


Gen(SCHEMA).run_from_stdin()
"""


def _raw_lines(n, seed):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        f = [str(int(rng.integers(0, 2))),
             ";".join(f"{rng.random():.5f}" for _ in range(3))]
        f += [";".join(str(int(k)) for k in
                       rng.integers(0, 1 << 63, rng.integers(0, 4),
                                    dtype=np.uint64)) for _ in range(3)]
        out.append(",".join(f))
    return out


def test_data_generator_as_pipe_command_bit_exact(tmp_path):
    raw = tmp_path / "raw.csv"
    raw.write_text("\n".join(_raw_lines(50, seed=9)) + "\n")
    cmds = []
    for pkg in ("paddlebox_tpu_torch", "paddlebox_tpu"):
        script = tmp_path / f"gen_{pkg}.py"
        script.write_text(_GENERATOR.format(repo=REPO, pkg=pkg, slots=SLOTS))
        cmds.append(f"{sys.executable} {script}")
    ours, ref = _load_pair(
        [str(raw)], lambda ds: ds.set_pipe_command(cmds[0]),
        lambda ds: ds.set_pipe_command(cmds[1]), global_shuffle=False)
    assert ours.num_examples == 50
    assert_records_identical(ours.records, ref.records)


def test_data_generator_with_ins_id(tmp_path):
    from paddlebox_tpu_torch.data import MultiSlotDataGenerator
    schema, _ = schemas()

    class Gen(MultiSlotDataGenerator):
        def generate_sample(self, line):
            yield line.split("|")[0], [("label", [1]), ("s0", [4, 5])]

    import io
    out = io.StringIO()
    assert Gen(schema, with_ins_id=True).process(["a|x\n", "b|y\n"],
                                                 out) == 2
    got = parser.parse_multislot_lines(out.getvalue().splitlines(), schema,
                                       with_ins_id=True)
    assert got.ins_id.tolist() == [hashing.hash64("a"), hashing.hash64("b")]
    np.testing.assert_array_equal(got.sparse_values[0], [4, 5, 4, 5])


def test_remote_paths_raise_not_ported(tmp_path):
    schema, _ = schemas()
    for kw in ({}, {"pipe_command": "cat"}):
        with pytest.raises(fs_lib.RemoteFSNotPorted):
            read_file("hdfs://nn/day/part-0", schema, **kw)
    with pytest.raises(fs_lib.RemoteFSNotPorted):
        read_file("afs://x/part-0.pbar", schema)
    # file:// is local
    p = tmp_path / "f"
    p.write_text("\n".join(make_lines(3)) + "\n")
    assert read_file(f"file://{p}", schema).num == 3


def test_tcp_shuffle_parts_raise_not_ported():
    schema, _ = schemas()
    with pytest.raises(NotImplementedError, match="item 11"):
        SlotDataset(schema, shuffle_service=object())
    ds = SlotDataset(schema)
    with pytest.raises(NotImplementedError, match="item 11"):
        ds.load_into_memory(routing="ins_id")
    with pytest.raises(NotImplementedError, match="item 11"):
        ds.member_shards(2)
    with pytest.raises(NotImplementedError, match="item 11"):
        ds.reroute_records(None, 2)


@pytest.mark.parametrize("parse_threads", [0, 1, 5])
def test_read_file_parse_threads_keep_records(tmp_path, parse_threads):
    files = _write_text_files(tmp_path, n_files=2, lines=200)
    schema, jschema = schemas()
    for f in files:
        assert_records_identical(
            read_file(f, schema, parse_threads=parse_threads),
            jax_reader.read_file(f, jschema))


def test_load_caps_parser_threads(tmp_path):
    files = _write_text_files(tmp_path, n_files=4, lines=60)
    ours, ref = _load_pair(files, global_shuffle=False)
    assert_records_identical(ours.records, ref.records)
    st = ours.last_load_stats
    assert st["parse_threads"] == parse_threads_per_file(4)
    assert (st["files"], st["records"], st["native"]) == (4, 240, 4)
    assert parse_threads_per_file(10 ** 6) == 1


# ---------------------------------------------------------------------------
# in-memory transforms
# ---------------------------------------------------------------------------

def _loaded_pair(tmp_path, with_ins_id=False, n=24):
    files = _write_text_files(tmp_path, lines=n, with_ins_id=with_ins_id)

    def ins(ds):
        ds.with_ins_id = with_ins_id
    ours, ref = _load_pair(files, ins, global_shuffle=True)
    assert_records_identical(ours.records, ref.records)
    return ours, ref


def test_slots_shuffle_bit_exact(tmp_path):
    ours, ref = _loaded_pair(tmp_path)
    for ds in (ours, ref):
        ds.slots_shuffle(["s0", "s1"], seed=4)
    assert_records_identical(ours.records, ref.records)
    before = ours.records.sparse_values[0].copy()
    with pytest.raises(ValueError):
        ours.slots_shuffle(["s0", "nope"])
    assert ours.records.sparse_values[0].tobytes() == before.tobytes()


@pytest.mark.parametrize("merge_size", [0, 2, 3])
def test_merge_by_ins_id_bit_exact(tmp_path, merge_size):
    # 7 distinct ins ids per file: groups of 3-4 members
    ours, ref = _loaded_pair(tmp_path, with_ins_id=True)
    d_ours = ours.merge_by_ins_id(merge_size=merge_size)
    d_ref = ref.merge_by_ins_id(merge_size=merge_size)
    assert d_ours == d_ref
    assert_records_identical(ours.records, ref.records)
    if merge_size == 0:
        assert d_ours == 0 and ours.num_examples == 21


def test_merge_by_ins_id_drops_odd_groups():
    schema, _ = schemas()
    ds = SlotDataset(schema)
    ds.records = parser.parse_multislot_lines(make_lines(5), schema)
    with pytest.raises(ValueError, match="real instance ids"):
        ds.merge_by_ins_id(2)
    ds.records.ins_id[:] = [7, 8, 7, 8, 9]
    assert ds.merge_by_ins_id(merge_size=2) == 1
    assert ds.num_examples == 2
    ds.records.ins_id[:] = [5, 6]
    assert ds.merge_by_ins_id(merge_size=2) == 2 and ds.num_examples == 0


def test_merge_by_search_id_bit_exact(tmp_path):
    ours, ref = _loaded_pair(tmp_path)
    sid = np.random.default_rng(2).integers(0, 9, ours.num_examples)
    for ds in (ours, ref):
        ds.records.search_id[:] = sid.astype(np.uint64)
    g_ours, g_ref = ours.merge_by_search_id(), ref.merge_by_search_id()
    assert g_ours.tobytes() == g_ref.tobytes()
    assert_records_identical(ours.records, ref.records)


@pytest.mark.parametrize("num_shards", [1, 3])
def test_prepare_train_shard_batches_bit_exact(tmp_path, num_shards):
    ours, ref = _loaded_pair(tmp_path)
    for ds in (ours, ref):
        ds.prepare_train(num_shards)
    for s in range(num_shards):
        assert_batches_identical(list(ours.shard_batches(s, 4)),
                                 list(ref.shard_batches(s, 4)))
    ours.release_memory()
    assert ours.records is None and ours.num_examples == 0
    with pytest.raises(RuntimeError, match="load_into_memory"):
        ours.unique_keys()


# ---------------------------------------------------------------------------
# QueueDataset
# ---------------------------------------------------------------------------

def _queues(files, num_threads, cap=2):
    schema, jschema = schemas()
    ours = QueueDataset(schema, num_threads=num_threads, queue_capacity=cap)
    ref = JaxQueue(jschema, num_threads=num_threads, queue_capacity=cap)
    for q in (ours, ref):
        q.set_filelist(files)
    return ours, ref


@pytest.mark.parametrize("bs,drop_last", [(10, True), (25, False)])
def test_queue_stream_single_thread_byte_identical(tmp_path, bs,
                                                   drop_last):
    # 24-line files and batches of 10 / 25: batches stitch across files
    files = _write_text_files(tmp_path, n_files=4)
    ours, ref = _queues(files, num_threads=1)
    got = list(ours.batches(bs, drop_last=drop_last))
    want = list(ref.batches(bs, drop_last=drop_last))
    assert_batches_identical(got, want)
    assert sum(b.num for b in got) == (90 if drop_last else 96)
    assert ours.last_stream_stats["records"] == 96
    assert ours.last_stream_stats["native"] == 4


def test_queue_stream_with_ins_id_matches_slot_dataset(tmp_path):
    files = _write_text_files(tmp_path, n_files=3, with_ins_id=True)
    schema, _ = schemas()
    q = QueueDataset(schema, num_threads=1)
    q.with_ins_id = True
    q.set_filelist(files)
    ds = SlotDataset(schema)
    ds.with_ins_id = True
    ds.set_filelist(files)
    ds.load_into_memory(global_shuffle=False)
    got = list(q.batches(16, drop_last=False))
    assert_batches_identical(got, list(ds.batches(16, drop_last=False)))
    assert got[0].ins_id.any()


def _example_multiset(batches):
    rows = []
    for b in batches:
        for i in range(b.num):
            rows.append(b.ids[i].tobytes() + b.mask[i].tobytes()
                        + b.floats[i].tobytes())
    return sorted(rows)


def test_queue_stream_multi_thread_same_examples(tmp_path):
    files = _write_text_files(tmp_path, n_files=6)
    ours, ref = _queues(files, num_threads=3, cap=1)
    got = list(ours.batches(16, drop_last=False))
    want = list(ref.batches(16, drop_last=False))
    assert sum(b.num for b in got) == 144
    assert _example_multiset(got) == _example_multiset(want)


def test_queue_shard_batches_partition_files(tmp_path):
    files = _write_text_files(tmp_path, n_files=4)
    ours, ref = _queues(files, num_threads=1)
    for s in range(2):
        assert_batches_identical(list(ours.shard_batches(s, 2, 12)),
                                 list(ref.shard_batches(s, 2, 12)))


def test_queue_reader_error_propagates(tmp_path):
    files = _write_text_files(tmp_path, n_files=2)
    ours, _ = _queues(files + [str(tmp_path / "missing.txt")], 2)
    with pytest.raises(OSError):
        list(ours.batches(8))


def test_queue_abandoned_iterator_reaps_readers(tmp_path):
    files = _write_text_files(tmp_path, n_files=4)
    ours, _ = _queues(files * 4, num_threads=3, cap=1)
    before = threading.active_count()
    it = ours.batches(8)
    next(it)                 # readers start and block on the full queue
    it.close()               # GeneratorExit: cancel, drain, join
    gc.collect()
    assert threading.active_count() <= before


def test_channel_close_drains():
    ch: Channel = Channel(capacity=4)
    for i in range(3):
        ch.put(i)
    ch.close()
    assert list(ch) == [0, 1, 2] and ch.closed
    with pytest.raises(RuntimeError, match="closed"):
        ch.put(9)
