"""Faults planted in the program underneath a run, for the check that a
broken timed path comes out not correct (``tests/test_portbench_faults``)
and for the faults' readings at a cell's own size (``control.py
--fault``). Each installs a patch in this process; nothing here runs in
a benchmark run.

- ``frozen_step``: a training step that returns its state unchanged (no
  push, the dense parameters put back);
- ``half_batch``: the loss and its gradients over half the batch, the
  mean taken over the rest;
- ``wrong_token``: one token a batch pulls and pushes another example's
  row;
- ``stale_row``: one row that a pass carries over from the last pass
  on the device served instead from the host store, which the lazy
  write-back has not brought up to date (the stale row);
- ``wrong_score``: the first answer of each scored batch altered by
  1e-3 where the predictor produces it.
"""

from __future__ import annotations

import types

import numpy as np


def frozen_step() -> None:
    import torch
    from paddlebox_tpu_torch.train import trainer
    orig = trainer.Trainer.train_step

    def frozen(self, table, idx, mask, dense, labels, plan=None,
               extras=(), defer=False, ablate=()):
        saved = [p.detach().clone() for p in self.params]
        out = orig(self, table, idx, mask, dense, labels, plan, extras,
                   ablate=("push",))
        with torch.no_grad():
            for p, s in zip(self.params, saved):
                p.copy_(s)
        return out

    trainer.Trainer.train_step = frozen


def half_batch() -> None:
    import torch.nn.functional as F
    from paddlebox_tpu_torch.train import trainer

    def half(logits, labels):
        n = logits.shape[0] // 2
        return F.binary_cross_entropy_with_logits(logits[:n], labels[:n])

    trainer.F = types.SimpleNamespace(binary_cross_entropy_with_logits=half)


def wrong_token() -> None:
    from paddlebox_tpu_torch.embedding import working_set
    orig = working_set.PassWorkingSet.translate

    def bent(self, ids, mask=None):
        idx = orig(self, ids, mask).copy()
        idx[0, 0] = idx[1, 0]
        return idx

    working_set.PassWorkingSet.translate = bent


def stale_row() -> None:
    import torch
    from paddlebox_tpu_torch.embedding import feed_pass
    orig = feed_pass.FeedPassManager._combine

    def bent(self, staged, test_mode):
        ws, carried = orig(self, staged, test_mode)
        resident = np.flatnonzero(staged.pos_prev >= 0)
        if len(resident):
            i = int(resident[0])
            row = self.store.peek_rows(staged.keys[i:i + 1])[0]
            ws.table[i + 1] = torch.from_numpy(row).to(ws.table.device)
        return ws, carried

    feed_pass.FeedPassManager._combine = bent


def wrong_score() -> None:
    from paddlebox_tpu_torch.inference import predictor
    orig = predictor.Predictor.predict

    def bent(self, ids, mask, dense=None):
        out = orig(self, ids, mask, dense).copy()
        out[0] += 1e-3
        return out

    predictor.Predictor.predict = bent


def install(name: str) -> None:
    {"frozen_step": frozen_step, "half_batch": half_batch,
     "wrong_token": wrong_token, "stale_row": stale_row,
     "wrong_score": wrong_score}[name]()
