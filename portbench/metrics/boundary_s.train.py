"""The pass boundary a pass: the harness's wall time from ``begin_pass``
to ``end_pass``'s return less ``train_pass``'s step loop
(``step_seconds``), mean over the window's passes, in s."""


def read(ctx: dict):
    passes = ctx["passes"]
    if not passes:
        return None
    return sum(wall - step for wall, step, _ in passes) / len(passes)
