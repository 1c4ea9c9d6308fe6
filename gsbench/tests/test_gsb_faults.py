"""A whole run at a small size on the CPU (the harness's look for a card
skipped, the program's plain composites in place of its kernels), sound
and with the timed path broken underneath: ``correct`` must come out true
for the sound run and false for every fault the cell can have, under the
cell's own limits. The controls (the reference in bfloat16 in the
program's place) must make ``correct`` false too."""

import time

import pytest
import torch

from gsbench import calibrate, harness
from gsbench.tests.tiny import tiny_cell

SEED = 2 ** 31 + 11
TRAIN = ("bicycle.train", "bicycle_grow.train_spec")


def run(cell, hooks=None, seconds=0.2):
    r = harness.run_cell(cell, SEED, seconds, False, "cpu",
                         time.perf_counter(), hooks)
    return r, harness.result(r, "cpu", 1)


def unchanged(step_fn):
    def step(params, adam, aux, *args, **kwargs):
        out = step_fn(params, adam, aux, *args, **kwargs)
        return params, adam, aux, out[3]
    return step


def stats_unchanged(step_fn):
    def step(params, adam, aux, *args, **kwargs):
        out = step_fn(params, adam, aux, *args, **kwargs)
        return out[0], out[1], aux, out[3]
    return step


def half_batch(monkeypatch, height):
    """Half of the batch (the image's rows) left out of the loss, the
    mean taken over the rest."""
    from mvs_gaussian_splatting_tpu_torch.train import grow_step, step
    from mvs_gaussian_splatting_tpu_torch.utils import losses
    half = height // 2
    for mod in (step, grow_step):
        monkeypatch.setattr(mod, "l1_loss", lambda a, b: losses.l1_loss(
            a[:, :half], b[:, :half]))
        monkeypatch.setattr(mod, "ssim", lambda a, b: losses.ssim(
            a[:, :half], b[:, :half]))


def altered_render(monkeypatch):
    """The training render altered where it is produced: a block of
    pixels blacked out."""
    from mvs_gaussian_splatting_tpu_torch.train import grow_step, step

    def black(img):
        img = img.clone()
        img[:, :16, :32] = 0.0
        return img
    orig_render, orig_raster = step.render, grow_step.rasterize

    def render(*a, **k):
        out = dict(orig_render(*a, **k))
        out["render"] = black(out["render"])
        return out

    def rasterize(*a, **k):
        img, aux = orig_raster(*a, **k)
        return black(img), aux
    monkeypatch.setattr(step, "render", render)
    monkeypatch.setattr(grow_step, "rasterize", rasterize)


@pytest.mark.parametrize("name", TRAIN)
def test_train_sound_and_faults(name, monkeypatch):
    cell = tiny_cell(name)
    _, out = run(cell)
    assert out["correct"], out["checks"]
    # a step that returns its state unchanged
    _, out = run(cell, {"step": unchanged})
    assert not out["correct"]
    assert out["checks"]["change_gap"]["value"] == pytest.approx(1.0)
    with monkeypatch.context() as m:
        half_batch(m, cell.config["height"])
        _, out = run(cell)
        assert not out["correct"], out["checks"]
    with monkeypatch.context() as m:
        altered_render(m)
        _, out = run(cell)
        c = out["checks"]["image_rmse"]
        assert c["value"] > c["limit"]
        assert not out["correct"]


def test_grow_statistics_left_unchanged():
    """The densification statistics (on in the speculative window) left
    as they were: stats_gap reads 1, and nothing else sees it."""
    cell = tiny_cell("bicycle_grow.train_spec")
    r, out = run(cell, {"step": stats_unchanged})
    assert out["checks"]["stats_gap"]["value"] == pytest.approx(1.0)
    assert not out["correct"]
    del out["checks"]["stats_gap"]
    assert all(c["value"] <= c["limit"] for c in out["checks"].values())


@pytest.mark.parametrize("name", TRAIN)
def test_train_control_fails(name):
    cell = tiny_cell(name)
    r, out = run(cell)
    assert out["correct"], out["checks"]
    rec = calibrate.controls(r, control=True, faults=True)
    assert not rec["control"]["correct"], rec["control"]
    assert not rec["half_batch"]["correct"], rec["half_batch"]
    if "stats_unchanged" in rec:
        assert not rec["stats_unchanged"]["correct"]
    assert ("stats_unchanged" in rec) == (name == "bicycle_grow.train_spec")


def test_render_sound_altered_and_control():
    cell = tiny_cell("bicycle.render_orbit")
    r, out = run(cell, seconds=2.0)
    assert out["correct"], out["checks"]
    rec = calibrate.controls(r, control=True, faults=False)
    assert not rec["control"]["correct"], rec["control"]

    def alter(img, pose):
        img = img.clone()
        img[:, :16, :32] = 0.0
        return img
    _, out = run(cell, {"image": alter}, seconds=2.0)
    assert not out["correct"]


@pytest.mark.gpu
@pytest.mark.parametrize("name", TRAIN + ("bicycle.render_orbit",))
def test_small_cells_on_the_card(name):
    """The same small cells through the program's CUDA kernels, traced:
    correct, and every per-layer metric the cell lists is read."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    cell = tiny_cell(name)
    r = harness.run_cell(cell, SEED, 1.0, True, "cuda", time.perf_counter())
    out = harness.result(r, torch.cuda.get_device_name(0), 1)
    assert out["correct"], out["checks"]
    assert set(out["metrics"]) == {m["name"] for m in cell.per_layer}
