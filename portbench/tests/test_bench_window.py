"""The window's count: a stage stopped at the deadline from inside its
objective, every call it counted finished inside the window."""

import time

import torch

from portbench.harness import _drive
from portbench.window import Window


class _FakeStage:
    """A stage of ``per_stage`` objective calls of ``items`` items, each
    taking ``pause`` seconds."""

    def __init__(self, per_stage, items, pause):
        self.per_stage, self.items, self.pause = per_stage, items, pause
        self.calls_made = 0

    def objective(self, idx, params):
        time.sleep(self.pause)
        self.calls_made += 1
        return torch.zeros(idx.shape[0], dtype=torch.float64)

    def run(self, window):
        f = window.site_objective(self.objective)
        idx = torch.arange(self.items)
        for _ in range(self.per_stage):
            f(idx, {"alpha": torch.ones(self.items, dtype=torch.float64)})


def test_stops_at_first_call_after_deadline():
    stage = _FakeStage(per_stage=1000, items=7, pause=0.01)
    window = Window(seconds=0.2)
    _drive(stage, window)
    assert window.stages == 0
    assert len(window.calls) == stage.calls_made          # nothing issued uncounted
    assert window.wall_s >= 0.2
    assert sum(c.items for c in window.calls) == 7 * stage.calls_made
    # the last counted call started before the deadline
    assert 0.2 / 0.01 * 0.5 < len(window.calls) <= 0.2 / 0.01 + 1


def test_stages_shorter_than_the_window_run_again():
    stage = _FakeStage(per_stage=3, items=5, pause=0.01)
    window = Window(seconds=0.25)
    _drive(stage, window)
    assert window.stages >= 3
    assert len(window.calls) == stage.calls_made
    assert len(window.calls) == 3 * window.stages + len(window.calls) % 3


def test_call_budget():
    stage = _FakeStage(per_stage=10, items=2, pause=0.0)
    window = Window(max_calls=14)
    _drive(stage, window)
    assert len(window.calls) == 14 == stage.calls_made
    assert window.stages == 1


def test_gene_gradient_kept_from_the_optimizer():
    window = Window()
    f = window.gene_objective(lambda p: (p["x"] ** 2).sum() + 3.0 * p["y"])
    x = torch.tensor([1.0, 2.0], dtype=torch.float64, requires_grad=True)
    params = {"x": x * 1.0, "y": x[0] * 0.0 + 0.5}
    value = f(params)
    (g,) = torch.autograd.grad(-value, x)
    call = window.calls[0]
    assert call.with_grad and float(call.value) == 5.0 + 1.5
    assert torch.allclose(-call.grads["x"], torch.tensor([2.0, 4.0], dtype=torch.float64))
    assert float(-call.grads["y"]) == 3.0
