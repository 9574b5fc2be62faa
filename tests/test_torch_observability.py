"""The training loop's observability against the JAX package's, on the CPU
(after tests/test_observability.py): ``DutyCycle``, ``StepTimer`` and
``Drawer`` fed the same calls, ``StepWatchdog``, ``HbmTracker`` and the
census, ``model_size`` on carried weights, ``flops`` and
``activation_memory_estimate`` of a matmul, ``Monitor``, a profiler trace,
and ``apply_reference_init``'s statistics."""

import builtins
import json
import os
import time

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from deepfake_tpu_torch.utils import logging as tlog
from deepfake_tpu_torch.utils import profiling as tprof
from tests.torch_port_helpers import torch_on_one_thread  # noqa: F401 (an autouse fixture)


class FakeClock:
    """time.perf_counter for both packages' timers: 0.25 s a call."""

    def __init__(self):
        self.t = 0.0

    def __call__(self):
        self.t += 0.25
        return self.t


def _feed(duty, timer):
    for step in range(7):
        timer.mark("dataload")
        duty.add("input_wait", timer.report("dataload"))
        timer.mark("step")
        duty.add("step", timer.elapsed("step"))
        if step % 3 == 2:
            timer.mark("ckpt")
            duty.add("ckpt", 2.0 + timer.elapsed("ckpt"))
        timer.report("step")
        duty.step()
    return [duty.share(k) for k in ("input_wait", "step", "ckpt", "absent")]


def test_duty_cycle_and_step_timer_match_jax(monkeypatch):
    """The same marks, reports and phase times into the port's and the JAX
    package's DutyCycle and StepTimer (one fake clock): the same log lines
    (``duty |`` every log_step steps, ``name : elapse`` every log_step-th
    report) and the same shares, which sum to 1."""
    from deepfake_tpu.utils import logging as jlog

    got, want = [], []
    monkeypatch.setattr(time, "perf_counter", FakeClock())
    shares = _feed(tlog.DutyCycle(got.append, 3), tlog.StepTimer(got.append, 3))
    monkeypatch.setattr(time, "perf_counter", FakeClock())
    jshares = _feed(jlog.DutyCycle(want.append, 3), jlog.StepTimer(want.append, 3))
    assert got == want and len(got) == 6
    assert any(s.startswith("duty | ckpt") for s in got)
    assert shares == jshares and abs(sum(shares) - 1.0) < 1e-12 and shares[3] == 0.0


def test_drawer_matches_jax_and_survives_without_matplotlib(tmp_path, monkeypatch):
    """The port's Drawer writes the JAX Drawer's file for the same updates
    (where matplotlib imports), draws nothing for an empty epoch, and where
    matplotlib does not import logs one line and returns None."""
    from deepfake_tpu.utils.logging import Drawer as JDrawer

    for d in ("j", "t"):
        (tmp_path / d).mkdir()
    jd, td = JDrawer("fused", "train", str(tmp_path / "j")), tlog.Drawer(
        "fused", "train", str(tmp_path / "t"))
    assert td.draw(0) is None and jd.draw(0) is None
    for v in (0.7, 0.5, 0.4):
        jd.update(v)
        td.update(v)
    want, got = jd.draw(2), td.draw(2)
    name = "Modality:fused_Phase:train_Epoch2.png"
    assert os.path.basename(got) == os.path.basename(want) == name
    assert os.path.getsize(got) > 0

    real_import = builtins.__import__

    def no_matplotlib(name, *a, **kw):
        if name.startswith("matplotlib"):
            raise ImportError(name)
        return real_import(name, *a, **kw)

    lines = []
    nodraw = tlog.Drawer("fused", "val", str(tmp_path / "none"), lines.append)
    nodraw.update(0.3)
    monkeypatch.setattr(builtins, "__import__", no_matplotlib)
    assert nodraw.draw(0) is None and nodraw.draw(1) is None
    monkeypatch.undo()
    assert len(lines) == 1 and "matplotlib" in lines[0]
    assert not os.path.exists(tmp_path / "none")


def test_step_watchdog_fires_once_per_section():
    """tests/test_observability.py:123-141 on the port's StepWatchdog: a
    slow section fires once, fast ones never, and the flag resets per
    section; close() stops the thread."""
    from deepfake_tpu_torch.utils.watchdog import StepWatchdog

    events = []
    wd = StepWatchdog(deadline_s=0.2, on_stall=events.append, poll_s=0.05)
    try:
        with wd.watch("fast"):
            time.sleep(0.05)
        assert not events
        with wd.watch("slow"):
            time.sleep(0.5)
        assert len(events) == 1 and "slow" in events[0] and wd.stall_count == 1
        with wd.watch("fast2"):
            time.sleep(0.05)
        assert len(events) == 1
    finally:
        wd.close()
    assert not wd._thread.is_alive()


def test_census_tracker_and_hbm_stats_on_the_cpu(tmp_path):
    """hbm_stats is {} on the CPU; the census counts a live tensor by dtype
    and shape; HbmTracker writes the JAX tracker's lines ('At step N Total
    HBM bytes', '+' for new groups, '-' for groups gone) every ``every``
    steps."""
    assert tprof.hbm_stats("cpu") == {}
    keep = torch.ones(123, 45)
    census = tprof.live_buffer_census("cpu")
    assert census["groups"]["float32[123, 45]"]["count"] >= 1
    assert census["total_bytes"] >= keep.numel() * 4
    tracker = tprof.HbmTracker(path=str(tmp_path), every=2, device_type="cpu")
    for _ in range(2):
        tracker.step()
        tracker.track()
    del keep
    gone = torch.zeros(7, 3, 11)
    for _ in range(2):
        tracker.step()
        tracker.track()
    text = open(tracker.file).read()
    assert text.count("At step") == 2 and "At step 2 Total HBM bytes:" in text
    assert "+ 1 x float32[7, 3, 11]" in text and "- 1 x float32[123, 45]" in text
    del gone


def test_model_size_matches_jax_on_carried_weights():
    """model_size of the port's NeXtVLAD (BatchNorm running statistics
    among its buffers) equals the JAX model_size of the variables carried
    into it (params and batch_stats)."""
    from deepfake_tpu.models.nextvlad import NeXtVLAD as JNeXtVLAD
    from deepfake_tpu.utils.profiling import model_size as jsize
    from deepfake_tpu_torch.io.jax_weights import load_jax_variables
    from deepfake_tpu_torch.models.nextvlad import NeXtVLAD

    from tests.torch_port_helpers import random_variables

    shape = dict(dim=64, num_clusters=8, lamb=2, groups=4, max_frames=6)
    variables = random_variables(JNeXtVLAD(**shape), jnp.zeros((1, 6, 64)))
    assert variables["batch_stats"]
    model = load_jax_variables(NeXtVLAD(**shape), variables)
    want, got = jsize(variables), tprof.model_size(model)
    assert got["params"] == want["params"] > 0
    assert got["mb"] == pytest.approx(want["mb"], rel=1e-12)
    assert got["params"] > sum(p.numel() for p in model.parameters())


def test_flops_and_activation_estimate_match_jax():
    """flops of a 64^3 matmul is 2 M N K, as xla_flops counts it
    (tests/test_observability.py:43); the activation estimate of
    tanh(x @ x) at [8, 8] equals the JAX estimator's, 2 x two outputs."""
    from deepfake_tpu.utils.profiling import activation_memory_estimate as jact, xla_flops

    n = 64
    a = torch.zeros(n, n)
    assert tprof.flops(lambda p, q: p @ q, a, a) == 2 * n ** 3
    want = xla_flops(lambda p, q: p @ q, jnp.zeros((n, n)), jnp.zeros((n, n)))
    if want is not None:  # cost analysis availability varies by backend
        assert tprof.flops(lambda p, q: p @ q, a, a) == pytest.approx(want, rel=0.01)
    got = tprof.activation_memory_estimate(lambda x: torch.tanh(x @ x), torch.zeros(8, 8))
    assert got == jact(lambda x: jnp.tanh(x @ x), jnp.zeros((8, 8))) == 2 * 2 * 8 * 8 * 4


def test_monitor_and_trace(tmp_path):
    """Monitor prints the JAX Monitor's line on the same calls; trace()
    writes a Chrome trace holding a step's range."""
    from deepfake_tpu.utils.profiling import Monitor as JMonitor

    got, want = [], []
    for mon, out in ((tprof.Monitor(3, got.append, device="cpu"), got),
                     (JMonitor(3, want.append), want)):
        for _ in range(7):
            mon()
            mon.step()
    assert len(got) == len(want) == 2 and got[0].startswith("HBM: ")
    with tprof.trace(str(tmp_path)):
        with tprof.StepAnnotation("train", 3):
            torch.ones(4).sum()
    (name,) = os.listdir(tmp_path)
    events = json.load(open(tmp_path / name))["traceEvents"]
    assert any(e.get("name") == "train 3" for e in events)


def test_reference_init_statistics_match_jax():
    """apply_reference_init, after tests/test_observability.py:52: conv
    weights xavier-normal with biases 0.3, linear weights kaiming-normal
    with biases 0, BatchNorm scales 1 and biases 0, in the port and in the
    JAX package, std within 15% of the rule's; the same generator state
    draws the same weights."""
    from deepfake_tpu.utils.init import apply_reference_init as jinit
    from deepfake_tpu_torch.models.layers import BatchNorm
    from deepfake_tpu_torch.utils.init import apply_reference_init

    def model():
        m = torch.nn.Module()
        m.conv = torch.nn.Conv2d(8, 16, 3)
        m.dense = torch.nn.Linear(128, 64)
        m.bn1 = BatchNorm(8)
        with torch.no_grad():
            m.dense.bias.fill_(1.0)
            m.bn1.weight.fill_(2.0)
            m.bn1.bias.fill_(3.0)
        return m

    m = apply_reference_init(model(), torch.Generator().manual_seed(0))
    jout = jinit({"conv": {"kernel": jnp.zeros((3, 3, 8, 16)), "bias": jnp.zeros((16,))},
                  "dense": {"kernel": jnp.zeros((128, 64)), "bias": jnp.ones((64,))},
                  "bn1": {"scale": jnp.full((8,), 2.0), "bias": jnp.full((8,), 3.0)}},
                 jax.random.PRNGKey(0))
    conv_std = np.sqrt(2.0 / (8 * 9 + 16 * 9))
    dense_std = np.sqrt(2.0 / 128)
    for got, want in ((m.conv.weight.detach().numpy(), conv_std),
                      (np.asarray(jout["conv"]["kernel"]), conv_std),
                      (m.dense.weight.detach().numpy(), dense_std),
                      (np.asarray(jout["dense"]["kernel"]), dense_std)):
        assert abs(got.std() - want) / want < 0.15
    np.testing.assert_allclose(m.conv.bias.detach().numpy(), 0.3)
    np.testing.assert_allclose(np.asarray(jout["conv"]["bias"]), 0.3)
    for t, j in ((m.dense.bias, jout["dense"]["bias"]), (m.bn1.bias, jout["bn1"]["bias"])):
        np.testing.assert_allclose(t.detach().numpy(), 0.0)
        np.testing.assert_allclose(np.asarray(j), 0.0)
    np.testing.assert_allclose(m.bn1.weight.detach().numpy(), 1.0)
    np.testing.assert_allclose(np.asarray(jout["bn1"]["scale"]), 1.0)
    again = apply_reference_init(model(), torch.Generator().manual_seed(0))
    assert torch.equal(again.conv.weight, m.conv.weight)
