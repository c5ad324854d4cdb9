"""The port's checkpointer, its checkpoint-restart loop and the training CLI.

Twins of the reference's checkpoint tests (``tests/test_substrate.py``) and
of its ``TrainLoopRunner`` tests (``tests/test_fault_tolerance.py``), on the
port's torch state: a bf16 + fp32 + int tree with factored leaves
round-trips bit for bit (the factors' padded rows kept), a ``.tmp``
directory is never restored, a corrupted leaf raises, retention keeps
``keep``, the zlib codec is recorded, and a run interrupted at step 5 and
resumed from the step-4 checkpoint ends on the same bits as an
uninterrupted one.  Then ``launch/train.py --reduced`` resumed from
``--ckpt-dir`` equals the uninterrupted run bit for bit, and
``launch/compress.py`` writes and reads checkpoints.  CPU only; no JAX.
"""

import json
import os

import numpy as np
import pytest
import torch

from repro_torch.checkpoint import checkpointer as ckpt
from repro_torch.configs.registry import get_arch
from repro_torch.core.lowrank import lowrank_params
from repro_torch.data.synthetic import SyntheticLM
from repro_torch.launch import compress as compress_cli
from repro_torch.launch import train as train_cli
from repro_torch.models.model import build_model
from repro_torch.runtime.fault_tolerance import RetryableStep, StepWatchdog, TrainLoopRunner
from repro_torch.train import optimizer as opt_mod
from repro_torch.train.train_step import TrainState, init_train_state, make_train_step
from torch_threads import one_torch_thread  # noqa: F401 (autouse: one intra-op thread)


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], f"{prefix}/{k}" if prefix else k)
    elif isinstance(tree, TrainState):
        yield from _leaves({"params": tree.params, "opt_state": tree.opt_state, "step": tree.step}, prefix)
    else:
        yield prefix, tree


def _assert_same_bits(a, b):
    la, lb = list(_leaves(a)), list(_leaves(b))
    assert [p for p, _ in la] == [p for p, _ in lb]
    for (path, x), (_, y) in zip(la, lb):
        assert x.dtype == y.dtype and x.shape == y.shape, path
        assert torch.equal(x.view(torch.int16) if x.dtype == torch.bfloat16 else x,
                           y.view(torch.int16) if y.dtype == torch.bfloat16 else y), path


def _tree():
    g = torch.Generator().manual_seed(0)
    return {
        "w": torch.randn((5, 7), generator=g).to(torch.bfloat16),
        "norm": {"scale": torch.randn((7,), generator=g)},
        "lin": lowrank_params(torch.randn((3, 9, 5), generator=g).to(torch.bfloat16),
                              torch.randn((3, 5, 11), generator=g).to(torch.bfloat16)),
        "count": torch.tensor([3, -1, 7], dtype=torch.int32),
        "step": torch.tensor(12, dtype=torch.int64),
    }


def test_roundtrip_bf16_fp32_int_and_factored_leaves_bitwise(tmp_path):
    state = _tree()
    ckpt.save(state, str(tmp_path), 7, extra={"note": "x"})
    assert ckpt.latest_step(str(tmp_path)) == 7
    template = {k: v for k, v in _tree().items()}
    template["w"] = torch.zeros_like(state["w"])  # values come from the checkpoint, layout from the template
    got, manifest = ckpt.restore(template, str(tmp_path))
    _assert_same_bits(got, state)
    assert got["lin"]["a"].stride() == state["lin"]["a"].stride() == (72, 8, 1)  # rows padded to 8
    assert manifest["step"] == 7 and manifest["extra"] == {"note": "x"}
    by_path = {m["path"]: m for m in manifest["leaves"]}
    assert by_path["w"]["dtype"] == "bfloat16" and by_path["count"]["dtype"] == "int32"


def test_tmp_directory_is_never_restored(tmp_path):
    d = str(tmp_path)
    ckpt.save(_tree(), d, 3)
    os.rename(os.path.join(d, "step_3"), os.path.join(d, "step_9.tmp"))  # a save cut before its rename
    assert ckpt.latest_step(d) is None
    ckpt.save(_tree(), d, 4)
    assert ckpt.latest_step(d) == 4 and not any(x.endswith(".tmp") for x in os.listdir(d))


def test_corrupted_leaf_raises(tmp_path):
    d = str(tmp_path)
    state = _tree()
    ckpt.save(state, d, 1)
    with open(os.path.join(d, "step_1", "manifest.json")) as f:
        leaf = json.load(f)["leaves"][0]["file"]
    with open(os.path.join(d, "step_1", leaf), "wb") as f:
        f.write(ckpt._Codec.compress(b"\x00" * 64, ckpt._Codec.default()))
    with pytest.raises(IOError, match="checksum"):
        ckpt.restore(state, d)


def test_async_checkpointer_retention(tmp_path):
    c = ckpt.Checkpointer(str(tmp_path), keep=2)
    for s in (1, 2, 3, 4):
        c.save_async({"w": torch.full((8,), float(s))}, s)
    c.wait()
    assert sorted(int(x.split("_")[1]) for x in os.listdir(tmp_path)) == [3, 4]
    got, _ = c.restore_latest({"w": torch.zeros(8)})
    assert torch.equal(got["w"], torch.full((8,), 4.0))


def test_save_async_snapshots_before_the_writer(tmp_path):
    """The state is copied to the host before save_async returns: a later
    in-place change does not reach the checkpoint."""
    c = ckpt.Checkpointer(str(tmp_path))
    w = torch.ones(1000)
    c.save_async({"w": w}, 1)
    w.fill_(5.0)
    c.wait()
    assert torch.equal(ckpt.restore({"w": w}, str(tmp_path))[0]["w"], torch.ones(1000))


def test_zlib_codec_is_recorded_and_restores(tmp_path, monkeypatch):
    monkeypatch.setattr(ckpt, "zstandard", None)
    state = _tree()
    ckpt.save(state, str(tmp_path), 2)
    with open(os.path.join(tmp_path, "step_2", "manifest.json")) as f:
        manifest = json.load(f)
    assert manifest["codec"] == "zlib" and manifest["version"] == 3
    _assert_same_bits(ckpt.restore(state, str(tmp_path))[0], state)


def test_raw_codec_roundtrip_and_unknown_codec(tmp_path):
    """``codec="raw"`` (for multi-GB states) stores the bytes as they are,
    checksummed like any other; an unknown codec is refused."""
    state = _tree()
    c = ckpt.Checkpointer(str(tmp_path), codec="raw")
    c.save_async(state, 3)
    c.wait()
    with open(os.path.join(tmp_path, "step_3", "manifest.json")) as f:
        manifest = json.load(f)
    assert manifest["codec"] == "raw" and manifest["version"] == 3
    w = next(m for m in manifest["leaves"] if m["path"] == "w")
    assert os.path.getsize(os.path.join(tmp_path, "step_3", w["file"])) == 5 * 7 * 2
    _assert_same_bits(c.restore_latest(state)[0], state)
    with pytest.raises(ValueError, match="codec"):
        ckpt.save(state, str(tmp_path), 4, codec="lz4")


def _mamba():
    cfg = get_arch("mamba2-130m", reduced=True)
    model = build_model(cfg, device="cpu")
    opt = opt_mod.adamw(opt_mod.constant_schedule(1e-3))
    return cfg, model, opt


def _to_tensors(b):
    return {k: torch.as_tensor(v) for k, v in b.items()}


def test_restart_resumes_identically(tmp_path):
    """Crash at step 5, restore the step-4 checkpoint, resume: the same bits as
    an uninterrupted run (the data and the step are deterministic)."""
    cfg, model, opt = _mamba()
    data = SyntheticLM(cfg, batch=4, seq=16, seed=3)
    step_fn = make_train_step(model, opt)

    def fresh():
        return init_train_state(model, opt, torch.Generator().manual_seed(0))

    d = str(tmp_path)
    c = ckpt.Checkpointer(d, keep=3)
    want, _ = TrainLoopRunner(step_fn, data.at_step, None, save_every=10**9).run(fresh(), 8, shard_fn=_to_tensors)
    with pytest.raises(RuntimeError, match="injected failure at step 5"):
        TrainLoopRunner(step_fn, data.at_step, c, save_every=2).run(fresh(), 8, shard_fn=_to_tensors,
                                                                    fail_at=lambda s: s == 5)
    c.wait()
    assert ckpt.latest_step(d) == 4
    restored, _ = ckpt.restore(fresh(), d)
    assert int(restored.step) == 4
    got, _ = TrainLoopRunner(step_fn, data.at_step, None, save_every=10**9).run(
        restored, 8, shard_fn=_to_tensors, start_step=4)
    _assert_same_bits(got, want)


# --------------------------------------------------------------------------- #
# TrainLoopRunner (twins of tests/test_fault_tolerance.py)
# --------------------------------------------------------------------------- #
class _MemCheckpointer:
    def __init__(self):
        self.saved = []  # (step, acc) in save order
        self.waits = 0

    def save_async(self, state, step):
        self.saved.append((step, int(state["acc"])))

    def wait(self):
        self.waits += 1


def _counting_step(state, batch):
    acc = state["acc"] + batch
    return {"acc": acc}, {"loss": acc.to(torch.float32)}


def _runner(c, save_every=2):
    return TrainLoopRunner(step_fn=_counting_step, data_at_step=lambda step: torch.tensor(step + 1, dtype=torch.int32),
                           checkpointer=c, save_every=save_every, watchdog=StepWatchdog(window=8))


def _zero():
    return {"acc": torch.tensor(0, dtype=torch.int32)}


def test_train_loop_runner_cadence_and_final_save():
    c = _MemCheckpointer()
    runner = _runner(c, save_every=2)
    state, metrics = runner.run(_zero(), 5)
    assert int(state["acc"]) == 15 and float(metrics["loss"]) == 15.0
    assert [s for s, _ in c.saved] == [2, 4, 5]
    assert c.waits == 1
    assert len(runner.watchdog.durations) == 5


def test_train_loop_runner_restart_resumes_deterministically():
    undisturbed = _runner(_MemCheckpointer(), save_every=3).run(_zero(), 7)[0]
    c = _MemCheckpointer()
    runner = _runner(c, save_every=3)
    with pytest.raises(RuntimeError, match="injected failure at step 5"):
        runner.run(_zero(), 7, fail_at=lambda s: s == 5)
    step, acc = c.saved[-1]
    assert (step, acc) == (3, 6)
    state, _ = runner.run({"acc": torch.tensor(acc, dtype=torch.int32)}, 7, start_step=step)
    assert int(state["acc"]) == int(undisturbed["acc"]) == 28


def test_train_loop_runner_retryable_step_and_metrics_hook():
    armed = {"on": True}

    def flaky(state, batch):
        if armed["on"] and int(batch) == 3:
            armed["on"] = False
            raise RuntimeError("link flap")
        return _counting_step(state, batch)

    wrapped = RetryableStep(flaky, max_retries=1, retryable=(RuntimeError,))
    seen = []
    runner = _runner(_MemCheckpointer(), save_every=10)
    runner.step_fn = wrapped
    state, _ = runner.run(_zero(), 4, on_metrics=lambda step, m: seen.append((step, float(m["loss"]))))
    assert wrapped.total_retries == 1
    assert int(state["acc"]) == 10
    assert seen == [(1, 1.0), (2, 3.0), (3, 6.0), (4, 10.0)]


def test_tests_run_torch_on_one_intra_op_thread():
    """The module's autouse fixture (``torch_threads``) is in force."""
    assert torch.get_num_threads() == 1


def test_train_loop_runner_no_checkpointer():
    runner = TrainLoopRunner(step_fn=_counting_step, data_at_step=lambda step: torch.tensor(1, dtype=torch.int32),
                             checkpointer=None)
    state, _ = runner.run(_zero(), 3)
    assert int(state["acc"]) == 3


# --------------------------------------------------------------------------- #
# the CLIs
# --------------------------------------------------------------------------- #
def test_train_cli_resumes_from_ckpt_dir_identically(tmp_path, capsys):
    """launch/train.py --reduced, compressed: 3 steps at once, and 2 steps then
    the same command at 3 steps, which resumes from --ckpt-dir; the two
    runs end on the same bits."""
    base = ["--arch", "llama3.2-1b", "--reduced", "--batch", "2", "--seq", "16", "--compress-alpha", "0.5",
            "--save-every", "1", "--log-every", "1", "--device", "cpu"]
    want, _ = train_cli.main(base + ["--steps", "3", "--ckpt-dir", str(tmp_path / "a")])
    train_cli.main(base + ["--steps", "2", "--ckpt-dir", str(tmp_path / "b")])
    got, metrics = train_cli.main(base + ["--steps", "3", "--ckpt-dir", str(tmp_path / "b")])
    out = capsys.readouterr().out
    assert f"[resume] restored step 2 from {tmp_path / 'b'}" in out and "[compress]" in out
    assert "step     3  loss" in out and "done: final loss" in out
    assert int(got.step) == 3 and np.isfinite(float(metrics["loss"]))
    _assert_same_bits(got, want)


def test_compress_cli_writes_and_reads_checkpoints(tmp_path, capsys):
    out_dir = str(tmp_path / "c")
    args = ["--arch", "llama3.2-1b", "--reduced", "--min-dim", "32", "--alpha", "0.5", "--device", "cpu"]
    params, rep = compress_cli.main(args + ["--out-ckpt", out_dir])
    assert f"[saved] {out_dir}/step_0" in capsys.readouterr().out
    got, manifest = ckpt.restore(params, out_dir)
    _assert_same_bits(got, params)
    assert manifest["extra"]["policy"]["alpha"] == 0.5
    # a dense params tree as --in-ckpt: the compression starts from its values
    cfg = get_arch("llama3.2-1b", reduced=True)
    dense = build_model(cfg, device="cpu").init(torch.Generator().manual_seed(5))
    ckpt.save(dense, str(tmp_path / "d"), 0)
    from_ckpt, _ = compress_cli.main(args + ["--in-ckpt", str(tmp_path / "d")])
    assert f"[load] {tmp_path / 'd'}" in capsys.readouterr().out
    assert torch.equal(from_ckpt["embed"], dense["embed"]) and not torch.equal(from_ckpt["embed"], params["embed"])
