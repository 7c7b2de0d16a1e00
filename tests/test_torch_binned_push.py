"""The port's binned push engine on the CPU: binned_merge_acc_plain,
merge_update_plain and binned_push against the JAX package's Pallas
kernels (interpret mode, as tests/test_binned_push.py and
tests/test_pallas_kernels.py run them), the host and device block plans,
and the push-engine and premerge choices against the JAX rule.

Tolerances: the accumulator's grad columns and the pushed table at
atol 2e-5 / rtol 1e-4 (test_binned_push.py's: summation order differs);
the show, clk and count columns exactly (sums of small integers);
merge_update at rtol 1e-6 / atol 1e-6 (test_pallas_kernels.py's); rows
no token touches keep their exact bits.

The CUDA kernels are held against these plain versions on the card by
tests/test_torch_kernels_cuda.py and chip_smoke.py.
"""

import types

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from paddlebox_tpu.config import flags as jax_flags
from paddlebox_tpu.embedding.config import EmbeddingConfig as JaxCfg
from paddlebox_tpu.native.key_index import block_plan as jax_block_plan
from paddlebox_tpu.ops import pallas_kernels as pk
from paddlebox_tpu.train import Trainer as JaxTrainer

from paddlebox_tpu_torch.config import flags
from paddlebox_tpu_torch.embedding import sharded
from paddlebox_tpu_torch.embedding.config import EmbeddingConfig
from paddlebox_tpu_torch.native import key_index
from paddlebox_tpu_torch.ops import kernels
from paddlebox_tpu_torch.train import Trainer

# One intra-op thread: several test workers share the cores with the JAX
# tests' 8-device CPU meshes.
torch.set_num_threads(1)

ACC_TOL = dict(atol=2e-5, rtol=1e-4)
MU_TOL = dict(rtol=1e-6, atol=1e-6)
N_ROWS = 4096          # a multiple of the TPU kernel's super-block


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _tokens(cfg, n_rows, n_tok, seed, skew=False, out_of_range=False):
    """A raw token stream: uniform or skewed ids (half the tokens on 20
    hot rows), optionally with ids below 0 and at or past n_rows."""
    rng = np.random.default_rng(seed)
    idx = rng.integers(0, n_rows, n_tok)
    if skew:
        idx[:n_tok // 2] = rng.integers(0, 20, n_tok // 2)
    if out_of_range:
        bad = rng.random(n_tok) < 0.1
        idx[bad] = rng.choice([-1, -7, n_rows, n_rows + 5], int(bad.sum()))
    idx = idx.astype(np.int32)
    grads = rng.normal(size=(n_tok, cfg.grad_width)).astype(np.float32)
    shows = np.ones(n_tok, np.float32)
    clks = (rng.random(n_tok) < 0.3).astype(np.float32)
    return idx, grads, shows, clks


def _table(cfg, n_rows, seed):
    rng = np.random.default_rng(seed)
    table = (rng.normal(size=(n_rows, cfg.row_width)) * 0.01).astype(
        np.float32)
    table[:, 0] = rng.integers(0, 20, n_rows)
    table[:, 1] = rng.integers(0, 5, n_rows)
    table[:, cfg.opt_cols] = np.abs(table[:, cfg.opt_cols])
    table[0] = 0.0
    return table


def _window_tokens(idx, order, rstart, end, super_block, n_rows):
    """The tokens the binned kernel adds, block by block: every position
    of a block's window whose id lies in that block's rows (the kernel's
    row-range check). Returns the token positions, duplicates kept."""
    got = []
    for b in range(len(rstart)):
        win = np.arange(rstart[b], end[b])
        tok = win if order is None else np.asarray(order)[win]
        lo, hi = b * super_block, min((b + 1) * super_block, n_rows)
        got.append(tok[(idx[tok] >= lo) & (idx[tok] < hi)])
    return np.sort(np.concatenate(got))


@pytest.mark.parametrize("with_plan", [False, True])
@pytest.mark.parametrize("case", ["uniform", "skew", "out_of_range"])
def test_binned_merge_acc_plain_matches_pallas(with_plan, case):
    kw = dict(dim=8, optimizer="adagrad", learning_rate=0.05)
    cfg, jcfg = EmbeddingConfig(**kw), JaxCfg(**kw)
    idx, grads, shows, clks = _tokens(
        cfg, N_ROWS, 2000, seed=len(case), skew=case == "skew",
        out_of_range=case == "out_of_range")
    jplan = plan = None
    if with_plan:
        SB, NB = pk.binned_push_geometry(jcfg, N_ROWS)
        jplan = tuple(map(jnp.asarray, jax_block_plan(idx, SB, NB)))
        plan = sharded.BlockPlan(*map(_t, key_index.block_plan(
            idx, *kernels.binned_geometry(cfg, N_ROWS))))
    want = np.asarray(pk.binned_merge_acc(
        jnp.asarray(idx), jnp.asarray(grads), jnp.asarray(shows),
        jnp.asarray(clks), jcfg, N_ROWS, n_split=3, plan=jplan,
        interpret=True))
    got = kernels.binned_merge_acc(_t(idx), _t(grads), _t(shows), _t(clks),
                                   cfg, N_ROWS, plan=plan).numpy()
    gw = cfg.grad_width
    assert got.shape == want.shape == (N_ROWS, gw + 3)
    np.testing.assert_allclose(got[:, :gw], want[:, :gw], **ACC_TOL)
    np.testing.assert_array_equal(got[:, gw:], want[:, gw:])
    valid = (idx >= 0) & (idx < N_ROWS)
    assert got[:, gw + 2].sum() == valid.sum()


_OPT_WNUM = [(o, w) for o in ("sgd", "adagrad", "adam", "ftrl")
             for w in (1, 2) if not (o == "ftrl" and w == 2)]


@pytest.mark.parametrize("opt,w_num", _OPT_WNUM)
def test_merge_update_plain_matches_pallas(opt, w_num):
    kw = dict(dim=8, optimizer=opt, learning_rate=0.05, embed_w_num=w_num)
    cfg, jcfg = EmbeddingConfig(**kw), JaxCfg(**kw)
    n_rows, gw = 256, cfg.grad_width
    table = _table(cfg, n_rows, seed=w_num)
    rng = np.random.default_rng(len(opt))
    acc = np.zeros((n_rows, gw + 3), np.float32)
    touched = rng.random(n_rows) < 0.4
    touched[0] = True                    # masked tokens: zero payload
    k = int(touched.sum())
    acc[touched, :gw] = rng.normal(scale=0.3, size=(k, gw))
    acc[touched, gw + 2] = rng.integers(1, 4, k)
    acc[touched, gw] = acc[touched, gw + 2]
    acc[touched, gw + 1] = rng.integers(0, 2, k)
    acc[0] = 0.0
    acc[0, gw + 2] = 5.0
    want = np.asarray(pk.merge_update(jnp.asarray(table), jnp.asarray(acc),
                                      jcfg, block_rows=32, interpret=True))
    got = kernels.merge_update(_t(table.copy()), _t(acc), cfg).numpy()
    np.testing.assert_allclose(got, want, **MU_TOL)
    np.testing.assert_array_equal(got[~touched], table[~touched])
    np.testing.assert_array_equal(got[0], 0.0)
    assert touched[1:].any() and (got[touched] != table[touched]).any()


@pytest.mark.parametrize("opt", ["adagrad", "adam"])
def test_binned_push_matches_pallas(opt):
    kw = dict(dim=8, optimizer=opt, learning_rate=0.05)
    cfg, jcfg = EmbeddingConfig(**kw), JaxCfg(**kw)
    table = _table(cfg, N_ROWS, seed=3)
    idx, grads, shows, clks = _tokens(cfg, N_ROWS, 2000, seed=5, skew=True,
                                      out_of_range=True)
    SB, NB = pk.binned_push_geometry(jcfg, N_ROWS)
    jplan = tuple(map(jnp.asarray, jax_block_plan(idx, SB, NB)))
    want = np.asarray(pk.binned_push(
        jnp.asarray(table), jnp.asarray(idx), jnp.asarray(grads),
        jnp.asarray(shows), jnp.asarray(clks), jcfg, plan=jplan,
        interpret=True))
    plan = sharded.BlockPlan(*map(_t, key_index.block_plan(
        idx, *kernels.binned_geometry(cfg, N_ROWS))))
    got_t = _t(table.copy())
    assert kernels.binned_push(got_t, _t(idx), _t(grads), _t(shows),
                               _t(clks), cfg, plan=plan) is got_t
    got = got_t.numpy()
    np.testing.assert_array_equal(got[:, :2], want[:, :2])
    np.testing.assert_allclose(got, want, **ACC_TOL)
    untouched = np.setdiff1d(np.arange(N_ROWS), idx)
    np.testing.assert_array_equal(got[untouched], table[untouched])


def test_binned_geometry():
    g = kernels.binned_geometry
    # the headline: P = 12 -> 2048 rows in 96 KB; a ragged last block
    assert g(EmbeddingConfig(dim=8), (1 << 19) + 1) == (2048, 257)
    assert g(EmbeddingConfig(dim=8), 1 << 19) == (2048, 256)
    # small tables take no bigger a block than they need
    assert g(EmbeddingConfig(dim=8), 301) == (512, 1)
    assert g(EmbeddingConfig(dim=8), 1) == (1, 1)
    assert g(EmbeddingConfig(dim=32), 1 << 20) == (512, 2048)
    assert g(EmbeddingConfig(dim=64), 1 << 20) == (256, 4096)
    assert g(EmbeddingConfig(dim=8), 0) is None
    assert not kernels.wide_rows(EmbeddingConfig(dim=56))   # 60 -> 64
    assert kernels.wide_rows(EmbeddingConfig(dim=64))       # 68 -> 72


@pytest.mark.parametrize("raw", [None, "0", "false", "1", "True", "yes"])
def test_binned_push_flag_env_matches_jax(monkeypatch, raw):
    """flags.binned_push: same name, default and PBTPU_BINNED_PUSH
    parsing as the JAX package's flag."""
    from paddlebox_tpu.config import Flags as JaxFlags
    from paddlebox_tpu_torch.config import Flags
    if raw is None:
        monkeypatch.delenv("PBTPU_BINNED_PUSH", raising=False)
    else:
        monkeypatch.setenv("PBTPU_BINNED_PUSH", raw)
    got = Flags.from_env().binned_push
    assert got is JaxFlags.from_env().binned_push
    assert got is (raw is None or raw.lower() in ("1", "true", "yes"))


@pytest.mark.parametrize("n_blocks,super_block", [(8, 512), (13, 64),
                                                  (1, 8192)])
def test_block_plan_native_matches_numpy(monkeypatch, n_blocks,
                                         super_block):
    n_rows = n_blocks * super_block - 5          # a ragged last block
    rng = np.random.default_rng(n_blocks)
    idx = rng.integers(-3000, n_rows + 700, 9001).astype(np.int32)
    want = key_index.block_plan(idx, super_block, n_blocks)
    assert key_index.get_lib() is not None
    for a, b in zip(want, jax_block_plan(idx, super_block, n_blocks)):
        np.testing.assert_array_equal(a, b)
    monkeypatch.setattr(key_index, "get_lib", lambda: None)
    got = key_index.block_plan(idx, super_block, n_blocks)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype == np.int32
        np.testing.assert_array_equal(a, b)


def test_block_plan_windows_round_down_to_8():
    """Block starts that are not multiples of 8 round down, so windows
    overlap their predecessors; the row-range check still counts each
    in-range token exactly once and drops the out-of-range ones."""
    sb, nb, n_rows = 16, 6, 90
    rng = np.random.default_rng(11)
    idx = rng.integers(-4, n_rows + 4, 203).astype(np.int32)
    order, rstart, end = key_index.block_plan(idx, sb, nb)
    starts = np.concatenate([[0], end[:-1]])
    assert (rstart % 8 == 0).all() and (rstart <= starts).all()
    assert (rstart < starts).any()          # the case under test
    assert end[-1] == len(idx)
    for b in range(nb):                     # grouped by block
        blk = np.clip(idx[order[starts[b]:end[b]]] // sb, 0, nb - 1)
        assert (blk == b).all()
    valid = np.flatnonzero((idx >= 0) & (idx < n_rows))
    np.testing.assert_array_equal(
        _window_tokens(idx, order, rstart, end, sb, n_rows), valid)


def test_device_block_plan_covers_every_valid_token_once():
    sb, nb, n_rows = 64, 7, 420
    rng = np.random.default_rng(12)
    idx = rng.integers(-9, n_rows + 30, 3001).astype(np.int32)
    order, rstart, end = kernels.device_block_plan(_t(idx), sb, nb)
    assert order.dtype == rstart.dtype == end.dtype == torch.int32
    valid = np.flatnonzero((idx >= 0) & (idx < n_rows))
    np.testing.assert_array_equal(
        _window_tokens(idx, order.numpy(), rstart.numpy(), end.numpy(), sb,
                       n_rows), valid)


def test_dedup_plan_windows_cover_unique_lanes():
    """The premerged lanes through the binned engine: the dedup plan's
    per-block lane windows (order None: lanes are sorted by row) reach
    each valid unique lane exactly once."""
    cfg = EmbeddingConfig(dim=8)
    n_rows = 3000
    sb, nb = kernels.binned_geometry(cfg, n_rows)
    rng = np.random.default_rng(13)
    idx = rng.integers(-2, n_rows + 2, 8000).astype(np.int32)
    _, uniq, _, rstart, end = key_index.dedup_plan(idx, n_rows, sb, nb)
    valid = np.flatnonzero(uniq < n_rows)
    np.testing.assert_array_equal(
        _window_tokens(uniq, None, rstart, end, sb, n_rows), valid)


def test_push_binned_engine_with_each_plan(monkeypatch):
    """sharded.push under a forced binned engine: raw tokens with a
    BlockPlan or none, and premerged lanes with the DedupPlan's windows,
    land on the same table as the xla_scatter engine."""
    cfg = EmbeddingConfig(dim=8, optimizer="adagrad")
    n_rows = 1500
    sb, nb = kernels.binned_geometry(cfg, n_rows)
    table = _table(cfg, n_rows, seed=21)
    idx, grads, shows, clks = _tokens(cfg, n_rows, 5000, seed=22,
                                      skew=True, out_of_range=True)
    args = (_t(idx), _t(grads), _t(shows), _t(clks), cfg)
    monkeypatch.setattr(flags, "push_engine", "xla_scatter")
    want = _t(table.copy())
    assert sharded.push(want, *args) == "xla_scatter"
    monkeypatch.setattr(flags, "push_engine", "binned_kernel")
    d = key_index.dedup_plan(idx, n_rows, sb, nb)
    for plan in (None,
                 sharded.BlockPlan(*map(_t, key_index.block_plan(idx, sb,
                                                                 nb))),
                 sharded.DedupPlan(*map(_t, d))):
        got = _t(table.copy())
        assert sharded.push(got, *args, plan=plan) == "binned_kernel"
        np.testing.assert_array_equal(got[:, :2].numpy(),
                                      want[:, :2].numpy())
        np.testing.assert_allclose(got.numpy(), want.numpy(), **ACC_TOL)


def test_xla_scatter_update_runs_merge_update(monkeypatch):
    """The xla_scatter engine's table update is the merge_update wrapper
    (the kernel on a card, its plain version here)."""
    cfg = EmbeddingConfig(dim=4)
    calls = []
    real = kernels.merge_update

    def spy(table, acc, c):
        calls.append(acc.shape)
        return real(table, acc, c)

    monkeypatch.setattr(kernels, "merge_update", spy)
    monkeypatch.setattr(flags, "push_engine", "xla_scatter")
    table = _t(_table(cfg, 50, seed=1))
    idx, grads, shows, clks = _tokens(cfg, 50, 40, seed=2)
    sharded.push(table, _t(idx), _t(grads), _t(shows), _t(clks), cfg)
    assert calls == [(50, cfg.grad_width + 3)]


# ---------------------------------------------------------------------------
# engine choices against the JAX rule (its TPU branch, with the card in
# the TPU's place)
# ---------------------------------------------------------------------------

_LAYOUTS = {"onehot_dim8": (8, 1), "onehot_dim64": (64, 1),
            "multihot4_dim32": (32, 4)}
_ENGINES = ("auto", "xla_scatter", "scatter_accumulate", "binned_kernel")
N_TPU = 1 << 19        # a row count with a TPU binned geometry


def _layout_ns(dim, max_len, num_slots=26):
    return types.SimpleNamespace(
        layout=types.SimpleNamespace(num_slots=num_slots,
                                     total_len=num_slots * max_len),
        store=types.SimpleNamespace(cfg=EmbeddingConfig(dim=dim)))


@pytest.mark.parametrize("engine", _ENGINES)
@pytest.mark.parametrize("layout", sorted(_LAYOUTS))
@pytest.mark.parametrize("binned_push", [True, False])
def test_engine_choice_follows_jax_rule(monkeypatch, layout, engine,
                                        binned_push):
    dim, max_len = _LAYOUTS[layout]
    for f in (flags, jax_flags):
        monkeypatch.setattr(f, "push_engine", engine)
        monkeypatch.setattr(f, "binned_push", binned_push)
    monkeypatch.setattr(jax, "default_backend", lambda: "tpu")
    port = _layout_ns(dim, max_len)
    jax_self = _layout_ns(dim, max_len)
    jax_self.store.cfg = JaxCfg(dim=dim)
    ws = types.SimpleNamespace(padded_rows=N_TPU)
    # the host plan exists on the TPU / the card while the binned engine
    # is enabled, or under a forced fused engine; the port also plans
    # under a forced binned engine, which the JAX trainer resolves only
    # on the TPU itself
    jax_plan = binned_push or engine == "scatter_accumulate"
    port_plan = jax_plan or engine == "binned_kernel"
    jax_premerged = jax_plan and JaxTrainer._dedup_premerge(jax_self, ws)
    port_premerged = port_plan and Trainer._dedup_premerge(port)
    if port_plan == jax_plan:
        assert port_premerged == jax_premerged
    want = pk.resolve_push_engine(JaxCfg(dim=dim), N_TPU,
                                  premerged=port_premerged)
    got = kernels.resolve_push_engine(port.store.cfg, N_TPU,
                                      premerged=port_premerged,
                                      device_type="cuda")
    assert got == want


def test_headline_layout_choices():
    """What auto picks on the card for the bench's layouts."""
    for layout, want_premerge, want_engine in (
            ("onehot_dim8", False, "binned_kernel"),
            ("onehot_dim64", True, "scatter_accumulate"),
            ("multihot4_dim32", True, "scatter_accumulate")):
        ns = _layout_ns(*_LAYOUTS[layout])
        prem = Trainer._dedup_premerge(ns)
        assert prem == want_premerge, layout
        assert kernels.resolve_push_engine(
            ns.store.cfg, (1 << 19) + 1, premerged=prem,
            device_type="cuda") == want_engine, layout
