"""The port's remote filesystems against the JAX package's, on the CPU:
``CommandFS`` (templates, retry with backoff, timeouts, the streaming
``cat``), ``init_afs_api``, ``resolve`` and the remote reads of the data
plane and ``FleetUtil``.

The port's CommandFS is driven by the stand-in CLI of tests/mockfs.py
(``MOCK_CLI`` / ``write_cli``: ``<scheme>://...`` URIs mapped onto a
sandbox directory, hadoop's nesting ``put`` included), registered here
through the port's own ``register_fs``. Cases mirror
tests/test_fs.py; where both packages can read the same remote file or
model, they must agree exactly.
"""

import os
import sys
import textwrap
import time

import numpy as np
import pytest

from paddlebox_tpu.data import DataFeedSchema as JaxSchema
from paddlebox_tpu.data import reader as jax_reader
from paddlebox_tpu.embedding import EmbeddingConfig as JaxCfg
from paddlebox_tpu.embedding import HostEmbeddingStore as JaxStore
from paddlebox_tpu.fleet.fleet_util import FleetUtil as JaxFleetUtil
from paddlebox_tpu.utils import fs as jax_fs

from paddlebox_tpu_torch import monitor
from paddlebox_tpu_torch.data import DataFeedSchema, SlotDataset
from paddlebox_tpu_torch.data.archive import write_archive
from paddlebox_tpu_torch.data.parser import parse_multislot_lines
from paddlebox_tpu_torch.data.reader import open_lines, read_file
from paddlebox_tpu_torch.embedding import EmbeddingConfig, HostEmbeddingStore
from paddlebox_tpu_torch.fleet import FleetUtil
from paddlebox_tpu_torch.utils import fs as fs_lib
from tests.mockfs import register_mockfs, write_cli


def register_port_mockfs(sandbox_root: str, scheme: str = "mock",
                         cli_path: str | None = None) -> fs_lib.CommandFS:
    """The port's CommandFS over tests/mockfs.py's CLI, registered for
    ``scheme`` in the port's registry."""
    os.makedirs(sandbox_root, exist_ok=True)
    cli = cli_path or write_cli(sandbox_root)
    base = f"{sys.executable} {cli}"
    fs = fs_lib.CommandFS(
        cat=f"{base} cat {{path}}", ls=f"{base} ls {{path}}",
        put=f"{base} put {{src}} {{dst}}", get=f"{base} get {{src}} {{dst}}",
        mkdir=f"{base} mkdir {{path}}", test=f"{base} test {{path}}",
        rm=f"{base} rm {{path}}",
        env={"MOCKFS_ROOT": str(sandbox_root), "MOCKFS_SCHEME": scheme})
    fs_lib.register_fs(scheme, fs)
    return fs


@pytest.fixture
def mockfs(tmp_path):
    """mock:// in both packages' registries, over one sandbox."""
    root = tmp_path / "mockfs_root"
    fs = register_port_mockfs(str(root))
    jfs = register_mockfs(str(root))
    yield fs, root, jfs
    fs_lib._REGISTRY.pop("mock", None)
    jax_fs._REGISTRY.pop("mock", None)


def test_resolve_and_unregistered_scheme(tmp_path):
    fs, p = fs_lib.resolve(str(tmp_path / "x.txt"))
    assert isinstance(fs, fs_lib.LocalFS) and p.endswith("x.txt")
    fs, p = fs_lib.resolve("file:///etc/hosts")
    assert isinstance(fs, fs_lib.LocalFS) and p == "/etc/hosts"
    assert not fs_lib.is_remote("file:///etc/hosts")
    assert fs_lib.is_remote("hdfs://ns1/a")
    # the same error in both packages: a scheme nobody registered is a
    # ValueError naming the scheme, never a local fallback
    for resolve in (fs_lib.resolve, jax_fs.resolve):
        with pytest.raises(ValueError, match="no filesystem registered"):
            resolve("nosuchscheme://a/b")


def test_command_fs_roundtrip(mockfs, tmp_path):
    fs, root, _ = mockfs
    fs.makedirs("mock://data")
    assert not fs.exists("mock://data/a.txt")
    fs.write_text("mock://data/a.txt", "hello\n")
    fs.write_text("mock://data/a.txt", "world\n", append=True)  # rmw path
    assert fs.exists("mock://data/a.txt")
    with fs.open_read("mock://data/a.txt") as f:
        assert f.read() == b"hello\nworld\n"
    assert fs.ls("mock://data") == ["mock://data/a.txt"]
    src = tmp_path / "tree"
    (src / "sub").mkdir(parents=True)
    (src / "sub" / "f.bin").write_bytes(b"\x01\x02")
    fs.put(str(src), "mock://up/tree")
    dst = tmp_path / "back"
    fs.get("mock://up/tree", str(dst))
    assert (dst / "sub" / "f.bin").read_bytes() == b"\x01\x02"
    fs.rm("mock://data/a.txt")
    assert not fs.exists("mock://data/a.txt")


def test_put_replacing_never_nests(mockfs, tmp_path):
    """hadoop's put into an existing directory nests the source under it;
    put_replacing lands the content at the target either way."""
    fs, root, _ = mockfs
    src = tmp_path / "m"
    src.mkdir()
    (src / "a").write_text("1")
    fs_lib.put_replacing(fs, str(src), "mock://r/t")
    (src / "a").write_text("2")
    fs_lib.put_replacing(fs, str(src), "mock://r/t")
    assert (root / "r" / "t" / "a").read_text() == "2"
    assert not (root / "r" / "t" / "m").exists()


def test_command_fs_cat_failure_raises(mockfs):
    fs, _, _ = mockfs
    stream = fs.open_read("mock://missing.txt")
    with pytest.raises(RuntimeError, match="cat failed"):
        stream.read()
        stream.close()


def _schema_pair(num_sparse=2, max_len=2):
    return (DataFeedSchema.ctr(num_sparse=num_sparse, num_float=0,
                               max_len=max_len),
            JaxSchema.ctr(num_sparse=num_sparse, num_float=0,
                          max_len=max_len))


def test_dataset_loads_remote_filelist(mockfs):
    """SlotDataset reads mock:// files exactly like local ones, and like
    the JAX package reads them (a remote filelist, the reference's
    LoadIntoMemoryByCommand over hadoop cat)."""
    fs, root, _ = mockfs
    schema, jschema = _schema_pair()
    lines = ["1 1 1 7 2 8 9", "1 0 1 3 1 4"]
    fs.makedirs("mock://day1")
    fs.write_text("mock://day1/part-0", "\n".join(lines) + "\n")
    ds = SlotDataset(schema)
    ds.set_filelist(["mock://day1/part-0"])
    ds.load_into_memory(global_shuffle=False)
    assert ds.num_examples == 2
    np.testing.assert_array_equal(ds.records.sparse_values[0], [7, 3])
    want = jax_reader.read_file("mock://day1/part-0", jschema)
    for a, b in zip(ds.records.sparse_values, want.sparse_values):
        assert a.tobytes() == np.asarray(b).tobytes()


@pytest.mark.parametrize("mode", ["text", "gzip", "pipe", "plugin"])
def test_remote_read_modes_match_local(mockfs, tmp_path, mode):
    """Each ingestion mode reads a remote file into the same batch as the
    local copy of it."""
    import gzip
    fs, root, _ = mockfs
    schema, _ = _schema_pair()
    rng = np.random.default_rng(3)
    lines = [f"1 {int(rng.integers(0, 2))} 1 {int(rng.integers(1, 99))} "
             f"2 {int(rng.integers(1, 99))} {int(rng.integers(1, 99))}"
             for _ in range(40)]
    text = ("\n".join(lines) + "\n").encode()
    name = "part-0.gz" if mode == "gzip" else "part-0"
    local = tmp_path / name
    local.write_bytes(gzip.compress(text) if mode == "gzip" else text)
    fs.makedirs("mock://day")
    fs.put(str(local), f"mock://day/{name}")
    kw = {}
    if mode == "pipe":
        kw["pipe_command"] = "cat"
    if mode == "plugin":
        kw["parser_plugin"] = lambda it, sch: parse_multislot_lines(
            list(it), sch)
    got = read_file(f"mock://day/{name}", schema, **kw)
    want = read_file(str(local), schema, **kw)
    assert got.num == want.num == 40
    for name in ("sparse_values", "sparse_offsets", "float_values"):
        for a, b in zip(getattr(got, name), getattr(want, name)):
            assert a.tobytes() == b.tobytes(), name


def test_open_lines_remote(mockfs):
    fs, _, _ = mockfs
    fs.makedirs("mock://t")
    fs.write_text("mock://t/f", "a\nb\n")
    assert list(open_lines("mock://t/f")) == ["a\n", "b\n"]


def test_remote_pbar_archive(mockfs, tmp_path):
    fs, root, _ = mockfs
    schema = DataFeedSchema.ctr(num_sparse=1, num_float=0, max_len=2)
    batch = parse_multislot_lines(["1 1 2 5 6", "1 0 1 9"], schema)
    local = tmp_path / "p.pbar"
    write_archive(str(local), batch)
    fs.makedirs("mock://arch")
    fs.put(str(local), "mock://arch/p.pbar")
    got = read_file("mock://arch/p.pbar", schema)
    assert got.num == 2
    np.testing.assert_array_equal(got.sparse_values[0], [5, 6, 9])


def test_remote_pipe_command_large_stream_no_deadlock(mockfs):
    """A multi-MB remote file through a pipe_command: the stdin feed and
    the stdout read overlap (write-then-read deadlocks once either pipe
    buffer fills)."""
    fs, root, _ = mockfs
    schema = DataFeedSchema.ctr(num_sparse=1, num_float=0, max_len=1)
    n = 60_000                                   # ~1.4 MB of text
    text = "\n".join(f"1 {i % 2} 1 {i % 97 + 1}" for i in range(n)) + "\n"
    fs.makedirs("mock://big")
    fs.write_text("mock://big/part-0", text)
    got = read_file("mock://big/part-0", schema, pipe_command="cat")
    assert got.num == n


def test_remote_pipe_early_exit_and_failures(mockfs):
    """A command that stops reading early (head) is not an error; a
    failing command or a missing remote file is."""
    fs, root, _ = mockfs
    schema = DataFeedSchema.ctr(num_sparse=1, num_float=0, max_len=1)
    text = "\n".join(f"1 1 1 {i + 1}" for i in range(50_000)) + "\n"
    fs.makedirs("mock://big")
    fs.write_text("mock://big/part-0", text)
    got = read_file("mock://big/part-0", schema, pipe_command="head -n 5")
    assert got.num == 5
    with pytest.raises(RuntimeError, match="exited"):
        read_file("mock://big/part-0", schema, pipe_command="false")
    with pytest.raises(RuntimeError):
        read_file("mock://big/missing", schema, pipe_command="cat")


def _fleet_store(cls, cfg_cls, v=1.0, n=20):
    store = cls(cfg_cls(dim=2))
    keys = np.arange(1, n + 1, dtype=np.uint64)
    rows = store.lookup_or_init(keys)
    rows[:, 2] = v
    store.write_back(keys, rows)
    return store, keys


def test_fleet_util_remote_root(mockfs):
    """Day/pass save and crash-recovery load against a remote root (the
    reference's HDFS day/pass layout, fleet_util.py:674-745)."""
    store = HostEmbeddingStore(EmbeddingConfig(dim=4))
    keys = np.arange(1, 30, dtype=np.uint64)
    rows = store.lookup_or_init(keys)
    rows[:, 2] = 1.5
    store.write_back(keys, rows)
    dense = {"w": np.ones((3, 2), np.float32)}
    fleet = FleetUtil("mock://fleet_out")
    fleet.save_model(store, dense, day=20260730)
    rows2 = store.get_rows(keys[:5])
    rows2[:, 2] = 9.0
    store.write_back(keys[:5], rows2)
    fleet.save_delta_model(store, dense, day=20260730, pass_id=1)
    assert fleet.latest()["day"] == 20260730
    store2, dense2, day = FleetUtil("mock://fleet_out").load_model(
        {"w": np.zeros((3, 2), np.float32)})
    assert day == 20260730
    np.testing.assert_array_equal(dense2["w"], dense["w"])
    got = store2.get_rows(keys)
    assert (got[:5, 2] == 9.0).all() and (got[5:, 2] == 1.5).all()


@pytest.mark.parametrize("writer,reader", [("port", "jax"), ("jax", "port")])
def test_fleet_util_remote_root_across_packages(mockfs, writer, reader):
    """A remote day model (a base and a pass delta) written by one package
    loads in the other: the same key → row map and dense tree."""
    pk = {"port": (HostEmbeddingStore, EmbeddingConfig, FleetUtil),
          "jax": (JaxStore, JaxCfg, JaxFleetUtil)}
    store_cls, cfg_cls, fleet_cls = pk[writer]
    store, keys = _fleet_store(store_cls, cfg_cls, v=1.25)
    dense = {"w": np.arange(6, dtype=np.float32).reshape(3, 2)}
    fleet = fleet_cls("mock://x")
    fleet.save_model(store, dense, day=7)
    rows = store.get_rows(keys[:4])
    rows[:, 3] = -2.0
    store.write_back(keys[:4], rows)
    fleet.save_delta_model(store, dense, day=7, pass_id=1)
    want = store.get_rows(keys)
    got_store, got_dense, day = pk[reader][2]("mock://x").load_model(
        {"w": np.zeros((3, 2), np.float32)})
    assert day == 7
    assert got_store.get_rows(keys).tobytes() == want.tobytes()
    assert np.asarray(got_dense["w"]).tobytes() == dense["w"].tobytes()


def test_fleet_util_remote_resave_replaces(mockfs):
    """Re-saving the same day replaces the remote model instead of nesting
    it under the existing directory."""
    fs, root, _ = mockfs
    store, keys = _fleet_store(HostEmbeddingStore, EmbeddingConfig)
    fleet = FleetUtil("mock://resave")
    fleet.save_model(store, {"w": np.zeros(2, np.float32)}, day=1)
    rows = store.get_rows(keys)
    rows[:, 2] = 2.0
    store.write_back(keys, rows)
    fleet.save_model(store, {"w": np.zeros(2, np.float32)}, day=1)
    assert not (root / "resave" / "1" / "base" / "m").exists()
    store2, _, _ = FleetUtil("mock://resave").load_model(
        {"w": np.zeros(2, np.float32)}, day=1)
    assert (store2.get_rows(keys)[:, 2] == 2.0).all()


def test_fleet_donefile_idempotent_on_crash_replay(mockfs):
    """append never retries; a replayed (day, pass, path) line is a no-op
    and a new pass still appends."""
    fs, root, _ = mockfs
    fleet = FleetUtil("mock://idem")
    fleet._write_donefile("delta_model.donefile", 1, 1, "mock://idem/1/d1")
    fleet._write_donefile("delta_model.donefile", 1, 1, "mock://idem/1/d1")
    lines = (root / "idem" / "delta_model.donefile").read_text().splitlines()
    assert len(lines) == 1
    fleet._write_donefile("delta_model.donefile", 1, 2, "mock://idem/1/d2")
    lines = (root / "idem" / "delta_model.donefile").read_text().splitlines()
    assert len(lines) == 2


def test_fleet_failed_upload_never_writes_donefile(mockfs, monkeypatch):
    """A model directory upload that fails past the retries leaves no
    donefile line naming it; the re-save after the outage lands both."""
    fs, root, _ = mockfs
    store, _ = _fleet_store(HostEmbeddingStore, EmbeddingConfig)
    fleet = FleetUtil("mock://up")
    monkeypatch.setitem(fs._env, "MOCKFS_FAIL_PUT_DIR", "1")
    monkeypatch.setattr(fs, "_retries", 2)
    monkeypatch.setattr(fs, "_retry_backoff", 0.01)
    with pytest.raises(RuntimeError, match="put failed after 2 attempts"):
        fleet.save_model(store, {"w": np.zeros(2, np.float32)}, day=1)
    assert not (root / "up" / "base_model.donefile").exists()
    assert fleet.latest() is None
    monkeypatch.delitem(fs._env, "MOCKFS_FAIL_PUT_DIR")
    fleet.save_model(store, {"w": np.zeros(2, np.float32)}, day=1)
    assert fleet.latest()["day"] == 1


def test_fleet_failed_base_download_falls_back_with_diagnostic(mockfs):
    fs, root, _ = mockfs
    fleet = FleetUtil("mock://fb")
    store1, keys = _fleet_store(HostEmbeddingStore, EmbeddingConfig, v=1.0)
    fleet.save_model(store1, {"w": np.ones(2, np.float32)}, day=1)
    store2, _ = _fleet_store(HostEmbeddingStore, EmbeddingConfig, v=2.0)
    fleet.save_model(store2, {"w": np.ones(2, np.float32) * 2}, day=2)
    fs.rm(fleet.base_dir(2))
    before = monitor.STATS.get("fleet.base_fetch_fallbacks")
    with pytest.warns(UserWarning, match="falling back"):
        got_store, dense, day = FleetUtil("mock://fb").load_model(
            {"w": np.zeros(2, np.float32)})
    assert day == 1
    assert (got_store.get_rows(keys)[:, 2] == 1.0).all()
    np.testing.assert_array_equal(dense["w"], np.ones(2, np.float32))
    assert monitor.STATS.get("fleet.base_fetch_fallbacks") == before + 1


def test_fleet_failed_delta_download_raises_diagnostic(mockfs):
    fs, root, _ = mockfs
    fleet = FleetUtil("mock://fd")
    store1, keys = _fleet_store(HostEmbeddingStore, EmbeddingConfig, v=1.0)
    fleet.save_model(store1, {"w": np.ones(2, np.float32)}, day=1)
    rows = store1.get_rows(keys[:3])
    rows[:, 2] = 9.0
    store1.write_back(keys[:3], rows)
    fleet.save_delta_model(store1, {"w": np.ones(2, np.float32)},
                           day=1, pass_id=1)
    fs.rm(fleet.delta_dir(1, 1))
    with pytest.raises(RuntimeError,
                       match=r"delta model .* pass 1.* failed to download"):
        FleetUtil("mock://fd").load_model({"w": np.zeros(2, np.float32)})


def test_command_fs_exists_raises_on_outage(tmp_path):
    """Exit codes other than 0/1 (an outage) raise instead of reading as
    "absent"."""
    fs = fs_lib.CommandFS(test="false")
    assert fs.exists("x://whatever") is False
    fs_bad = fs_lib.CommandFS(test="sh -c 'exit 2'")
    with pytest.raises(RuntimeError, match="test failed"):
        fs_bad.exists("x://whatever")


def test_init_afs_api_registers_schemes():
    kw = dict(fs_user="u", fs_passwd="p", conf_path="/etc/hadoop/conf",
              hadoop_bin="/usr/lib/hadoop/bin/hadoop", schemes=("afstest",))
    fs = fs_lib.init_afs_api("hdfs://ns1", **kw)
    jfs = jax_fs.init_afs_api("hdfs://ns1", **kw)
    try:
        got, _ = fs_lib.resolve("afstest://a/b")
        assert got is fs
        # the credentials ride the environment, never the argv
        assert "hadoop.job.ugi=u,p" in fs._env.get("HADOOP_CLIENT_OPTS", "")
        assert not any("hadoop.job.ugi" in a
                       for a in fs._argv("cat", path="x"))
        # the same commands as the reference's, op for op
        for op, kw in (("cat", {"path": "afstest://a"}),
                       ("ls", {"path": "afstest://a"}),
                       ("put", {"src": "/l", "dst": "afstest://r"}),
                       ("get", {"src": "afstest://r", "dst": "/l"}),
                       ("mkdir", {"path": "afstest://d"}),
                       ("test", {"path": "afstest://d"}),
                       ("rm", {"path": "afstest://d"})):
            assert fs._argv(op, **kw) == jfs._argv(op, **kw), op
        assert fs._argv("cat", path="p")[:3] == [
            "/usr/lib/hadoop/bin/hadoop", "--config", "/etc/hadoop/conf"]
    finally:
        fs_lib._REGISTRY.pop("afstest", None)
        jax_fs._REGISTRY.pop("afstest", None)


def test_init_afs_api_stand_in_cli_end_to_end(tmp_path):
    """init_afs_api over a stand-in hadoop executable: the whole remote
    surface (put, ls, cat, test, get, rm) resolves through the scheme."""
    cli = tmp_path / "hadoop"
    cli.write_text(textwrap.dedent(f"""\
        #!{sys.executable}
        import os, shutil, sys
        ROOT = {str(tmp_path / 'remote')!r}
        args = [a for a in sys.argv[1:] if not a.startswith("-D")]
        assert args[0] == "fs", args
        op, rest = args[1], args[2:]
        def local(p):
            return os.path.join(ROOT, p.split("://", 1)[1])
        if op == "-cat":
            sys.stdout.buffer.write(open(local(rest[0]), "rb").read())
        elif op == "-ls":
            for n in sorted(os.listdir(local(rest[0]))):
                print(rest[0].rstrip("/") + "/" + n)
        elif op == "-put":
            src, dst = rest[-2], local(rest[-1])
            os.makedirs(os.path.dirname(dst), exist_ok=True)
            (shutil.copytree if os.path.isdir(src) else shutil.copy2)(
                src, dst)
        elif op == "-get":
            src, dst = local(rest[0]), rest[1]
            (shutil.copytree if os.path.isdir(src) else shutil.copy2)(
                src, dst)
        elif op == "-mkdir":
            os.makedirs(local(rest[-1]), exist_ok=True)
        elif op == "-test":
            sys.exit(0 if os.path.exists(local(rest[-1])) else 1)
        elif op == "-rm":
            p = local(rest[-1])
            shutil.rmtree(p) if os.path.isdir(p) else (
                os.remove(p) if os.path.exists(p) else None)
        """))
    cli.chmod(0o755)
    fs = fs_lib.init_afs_api("afsx://cluster", hadoop_bin=str(cli),
                             schemes=("afsx",))
    try:
        fs.makedirs("afsx://c/d")
        fs.write_text("afsx://c/d/f", "x\n")
        fs.write_text("afsx://c/d/f", "y\n", append=True)
        assert list(open_lines("afsx://c/d/f")) == ["x\n", "y\n"]
        assert fs.ls("afsx://c/d") == ["afsx://c/d/f"]
        fs.get("afsx://c/d/f", str(tmp_path / "back"))
        assert (tmp_path / "back").read_text() == "x\ny\n"
        fs.rm("afsx://c/d/f")
        assert not fs.exists("afsx://c/d/f")
    finally:
        fs_lib._REGISTRY.pop("afsx", None)


def test_command_fs_braces_in_paths(tmp_path):
    """Literal braces in object names: only the known placeholders are
    substituted."""
    fs = fs_lib.CommandFS(cat="cat {path}")
    p = tmp_path / "weird{0}name.txt"
    p.write_text("hello")
    with fs.open_read(str(p)) as f:
        assert f.read() == b"hello"
    fs2 = fs_lib.CommandFS(
        test="sh -c 'case {path} in *x*) exit 0;; *) exit 1;; esac' "
             "--ignored")
    assert fs2._argv("test", path="a{b}x")[-2].count("{path}") == 0


def test_command_fs_ls_paths_with_spaces(tmp_path):
    listing = tmp_path / "listing.txt"
    listing.write_text(
        "Found 2 items\n"
        "-rw-r--r--   3 user group 12 2026-01-01 10:00 /data/name with "
        "spaces\n"
        "drwxr-xr-x   - user group  0 2026-01-01 10:00 /data/plain\n")
    fs = fs_lib.CommandFS(ls=f"cat {listing}")
    assert fs.ls("ignored://") == ["/data/name with spaces", "/data/plain"]


def test_command_stream_early_close_kills_producer():
    """Closing a partly read stream kills the producer instead of
    draining it; a stream read to its end keeps the exit-code check."""
    fs = fs_lib.CommandFS(
        cat="sh -c 'yes data-{path} | head -c 100000000; sleep 30'")
    t0 = time.time()
    with fs.open_read("x") as f:
        head = f.read(64)
    assert head.startswith(b"data-x")
    assert time.time() - t0 < 5.0
    fs_bad = fs_lib.CommandFS(cat="sh -c 'echo hi; exit 3'")
    with pytest.raises(RuntimeError, match="cat failed"):
        with fs_bad.open_read("x") as f:
            f.read()


def test_argv_no_resubstitution_and_close_idempotent(tmp_path):
    fs = fs_lib.CommandFS(put="cp {src} {dst}")
    argv = fs._argv("put", src="/tmp/x{dst}y", dst="/data/out")
    assert argv == ["cp", "/tmp/x{dst}y", "/data/out"]
    fs_bad = fs_lib.CommandFS(cat="sh -c 'echo hi; exit 3'")
    f = fs_bad.open_read("x")
    f.read()
    with pytest.raises(RuntimeError, match="cat failed"):
        f.close()
    f.close()


FLAKY_CLI = textwrap.dedent("""
    import os, shutil, sys
    marker = os.environ["FLAKY_COUNTER"]
    n = int(open(marker).read()) if os.path.exists(marker) else 0
    open(marker, "w").write(str(n + 1))
    if n < int(os.environ.get("FLAKY_FAILS", "2")):
        sys.stderr.write("transient outage #%d\\n" % (n + 1))
        sys.exit(5)
    shutil.copy2(sys.argv[1], sys.argv[2])
""")


def _flaky_fs(tmp_path, fails, **kw):
    cli = tmp_path / "flaky_cli.py"
    cli.write_text(FLAKY_CLI)
    counter = tmp_path / "counter"
    fs = fs_lib.CommandFS(
        put=f"{sys.executable} {cli} {{src}} {{dst}}",
        env={"FLAKY_COUNTER": str(counter), "FLAKY_FAILS": str(fails)},
        retry_backoff=0.01, **kw)
    return fs, counter


def test_command_fs_retry_recovers_from_transient_failures(tmp_path):
    fs, counter = _flaky_fs(tmp_path, fails=2, retries=3)
    src = tmp_path / "src.txt"
    src.write_text("payload")
    dst = tmp_path / "dst.txt"
    before = monitor.STATS.get("fs.put.recovered")
    fs.put(str(src), str(dst))
    assert dst.read_text() == "payload"
    assert counter.read_text() == "3"
    assert monitor.STATS.get("fs.put.recovered") == before + 1


def test_command_fs_retry_exhaustion_reports_attempts(tmp_path):
    fs, counter = _flaky_fs(tmp_path, fails=99, retries=3)
    src = tmp_path / "src.txt"
    src.write_text("payload")
    with pytest.raises(RuntimeError,
                       match=r"put failed after 3 attempts") as ei:
        fs.put(str(src), str(tmp_path / "dst.txt"))
    assert counter.read_text() == "3"
    assert "transient outage" in str(ei.value)


def test_command_fs_retry_follows_the_flags(tmp_path, monkeypatch):
    """Unset constructor arguments read flags.fs_retry_attempts /
    fs_retry_backoff_s at call time."""
    from paddlebox_tpu_torch.config import flags
    monkeypatch.setattr(flags, "fs_retry_attempts", 2)
    monkeypatch.setattr(flags, "fs_retry_backoff_s", 0.01)
    cli = tmp_path / "flaky_cli.py"
    cli.write_text(FLAKY_CLI)
    counter = tmp_path / "counter"
    fs = fs_lib.CommandFS(
        put=f"{sys.executable} {cli} {{src}} {{dst}}",
        env={"FLAKY_COUNTER": str(counter), "FLAKY_FAILS": "99"})
    src = tmp_path / "src.txt"
    src.write_text("p")
    with pytest.raises(RuntimeError, match="after 2 attempts"):
        fs.put(str(src), str(tmp_path / "d"))
    assert counter.read_text() == "2"


def test_command_fs_append_and_test_never_retry(tmp_path):
    cli = tmp_path / "count_cli.py"
    cli.write_text(textwrap.dedent("""
        import os, sys
        marker = os.environ["FLAKY_COUNTER"]
        n = int(open(marker).read()) if os.path.exists(marker) else 0
        open(marker, "w").write(str(n + 1))
        sys.exit(5)
    """))
    counter = tmp_path / "counter"
    base = f"{sys.executable} {cli}"
    fs = fs_lib.CommandFS(
        put=f"{base} {{src}} {{dst}}", append=f"{base} {{src}} {{dst}}",
        test=f"{base} {{path}}", env={"FLAKY_COUNTER": str(counter)},
        retries=4, retry_backoff=0.01)
    with pytest.raises(RuntimeError, match="append failed after 1 attempt"):
        fs._run("append", src="a", dst="b")
    assert counter.read_text() == "1"
    counter.write_text("0")
    with pytest.raises(RuntimeError, match="test failed after 1 attempt"):
        fs._run("test", path="x")
    assert counter.read_text() == "1"


def test_command_fs_timeout_counts_as_failed_attempt(tmp_path):
    fs = fs_lib.CommandFS(put="sleep 30", retries=2, retry_backoff=0.01,
                          timeout=0.2)
    t0 = time.time()
    with pytest.raises(RuntimeError,
                       match=r"put failed after 2 attempts.*timed out"):
        fs.put("a", "b")
    assert time.time() - t0 < 10.0


GET_CLI = textwrap.dedent("""
    import os, shutil, sys
    src, dst = sys.argv[1], sys.argv[2]
    if os.path.isdir(dst):
        dst = os.path.join(dst, os.path.basename(src.rstrip("/")))
    if os.path.exists(dst):
        sys.stderr.write("get: %s: File exists\\n" % dst)
        sys.exit(1)
    marker = os.environ["FLAKY_COUNTER"]
    n = int(open(marker).read()) if os.path.exists(marker) else 0
    open(marker, "w").write(str(n + 1))
    if n < 1:
        open(dst, "w").write("PARTIAL")   # a torn download, then death
        sys.exit(5)
    shutil.copy2(src, dst)
""")


def _get_fs(tmp_path):
    cli = tmp_path / "get_cli.py"
    cli.write_text(GET_CLI)
    return fs_lib.CommandFS(
        get=f"{sys.executable} {cli} {{src}} {{dst}}",
        env={"FLAKY_COUNTER": str(tmp_path / "counter")},
        retries=3, retry_backoff=0.01)


def test_command_fs_get_retry_cleans_partial_download(tmp_path):
    src = tmp_path / "remote.txt"
    src.write_text("full payload")
    dst = tmp_path / "local.txt"
    _get_fs(tmp_path).get(str(src), str(dst))
    assert dst.read_text() == "full payload"


def test_command_fs_get_retry_preserves_preexisting_dst(tmp_path):
    """Only what a failed attempt created is removed: a dst directory that
    existed before, and its other contents, survive the retries."""
    src = tmp_path / "remote.txt"
    src.write_text("full payload")
    dst_dir = tmp_path / "downloads"
    dst_dir.mkdir()
    (dst_dir / "unrelated.txt").write_text("precious")
    _get_fs(tmp_path).get(str(src), str(dst_dir))
    assert (dst_dir / "unrelated.txt").read_text() == "precious"
    assert (dst_dir / "remote.txt").read_text() == "full payload"


def test_command_fs_ctor_timeout_zero_means_no_timeout(tmp_path):
    fs = fs_lib.CommandFS(put="cp {src} {dst}", retries=1, timeout=0)
    src = tmp_path / "a.txt"
    src.write_text("x")
    fs.put(str(src), str(tmp_path / "b.txt"))
    assert (tmp_path / "b.txt").read_text() == "x"
