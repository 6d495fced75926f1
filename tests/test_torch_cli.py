"""The port's CLI against the JAX CLI: the parser's subcommands and options
(the JAX parser's, with `--device`), and `main` on each command that runs on
the CPU at a small size, printing the JAX CLI's JSON keys; `run_standing`'s
and `run_fleet`'s final metrics in f64 against the JAX CLI's at the same
arguments, `run_fleet`'s checkpoints against the JAX CLI's and its
`--resume` from one the JAX CLI wrote. `run_hardware` is checked for what it
hands the loop (the threaded loop itself runs in
`test_torch_hardware_threaded.py` and on the card)."""

import json

import numpy as np
import pytest

import quaternion_mpc_tpu_torch
from quaternion_mpc_tpu import cli as jcli
from quaternion_mpc_tpu_torch import cli as tcli

quaternion_mpc_tpu_torch.set_default_device("cpu")

CPU = ["--device", "cpu"]


def _subparsers(parser):
    action = next(a for a in parser._actions if a.__class__.__name__ == "_SubParsersAction")
    return action.choices


def _options(parser):
    return {a.dest: (tuple(a.option_strings), a.default, a.type, a.choices, a.required)
            for a in parser._actions if a.dest != "help"}


def test_parser_is_the_references_without_run_fleet_and_with_device():
    """Every subcommand of the reference, run_fleet among them, with its
    options, and `--device` besides."""
    ours, theirs = _subparsers(tcli.build_parser()), _subparsers(jcli.build_parser())
    assert set(ours) == set(theirs) and "run_fleet" in ours
    for name, p in ours.items():
        opts, ref = _options(p), _options(theirs[name])
        assert opts.pop("device") == (("--device",), "cuda", None, None, False), name
        assert opts == ref, name
        assert p.get_default("fn").__name__ == theirs[name].get_default("fn").__name__


def _leaves(path):
    with np.load(path) as data:
        return [data[f"leaf_{i}"] for i in range(len(data.files))]


def _carries_close(port_npz, jax_npz, rel=1e-10):
    """The two checkpoints' carries leaf by leaf: the same keys, each leaf
    within ``rel`` of its scale (the packages differ in the order of the
    solver's sums only)."""
    assert (json.loads(port_npz.with_suffix(".json").read_text())["keys"]
            == json.loads(jax_npz.with_suffix(".json").read_text())["keys"])
    for a, b in zip(_leaves(port_npz), _leaves(jax_npz)):
        assert a.dtype == b.dtype and a.shape == b.shape
        scale = max(1.0, float(np.max(np.abs(b.astype(np.float64)))))
        assert float(np.max(np.abs(a.astype(np.float64) - b))) <= rel * scale


@pytest.mark.parametrize("walk", ["0.0", "0.3"], ids=["standing", "walking"])
def test_run_fleet_names_the_next_slice(capsys, tmp_path, walk):
    """`run_fleet` against the JAX CLI's `cmd_run_fleet` (its 8-device CPU
    mesh, the port's one rank) in f64: the fleet totals as printed (rounded
    to 4 and 5 places: held to the last place), the final carries leaf by
    leaf to 1e-10 of scale; standing, a `--resume` from the checkpoint the
    JAX CLI wrote, against the JAX CLI's own resume of it. B=16: two
    scenarios a JAX device, so both packages run the sweep (at one a device
    the reference's "auto" backend takes the associative scan, which
    differs from the sweep by design at reg > 0)."""
    argv = ["run_fleet", "--batch", "16", "--steps", "2", "--horizon", "4", "--f64",
            "--walk", walk]
    jck, tck = tmp_path / "jax.npz", tmp_path / "port.npz"
    assert jcli.main(argv + ["--checkpoint", str(jck.with_suffix(""))]) == 0
    ref = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    out = _run(capsys, argv + CPU + ["--checkpoint", str(tck.with_suffix(""))])
    assert set(out) == set(ref) == {"devices", "batch", "steps", "wall_s", "solves_per_sec",
                                    "fleet_alive", "fleet_mean_cost", "resumed_at"}
    assert out["devices"] == 1 and ref["devices"] == 8
    assert out["fleet_alive"] == ref["fleet_alive"] == 1.0
    assert out["fleet_mean_cost"] == pytest.approx(ref["fleet_mean_cost"], abs=1e-5)
    _carries_close(tck, jck)
    if walk != "0.0":
        return
    resumed = argv + ["--resume", str(jck.with_suffix(""))]
    assert jcli.main(resumed + ["--checkpoint", str(tmp_path / "jax2")]) == 0
    ref = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    out = _run(capsys, resumed + CPU + ["--checkpoint", str(tmp_path / "port2")])
    assert out["resumed_at"] == ref["resumed_at"] == 2
    assert out["fleet_mean_cost"] == pytest.approx(ref["fleet_mean_cost"], abs=1e-5)
    _carries_close(tmp_path / "port2.npz", tmp_path / "jax2.npz")


def _run(capsys, argv):
    assert tcli.main(argv) == 0
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


def test_bench_solver(capsys):
    out = _run(capsys, ["bench_solver", "--batch", "2", "--iters", "2"] + CPU)
    assert set(out) == {"batch", "horizon", "p50_step_ms", "solves_per_sec", "per_solve_ms",
                        "mean_cost"}
    assert out["batch"] == 2 and out["solves_per_sec"] > 0 and np.isfinite(out["mean_cost"])


def test_run_standing_matches_the_reference_cli(capsys, tmp_path):
    argv = ["run_standing", "--batch", "2", "--steps", "3", "--f64"]
    out = _run(capsys, argv + CPU + ["--log", str(tmp_path / "t.jsonl")])
    assert jcli.main(argv) == 0
    ref = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert set(out) == set(ref)
    for k in ("height_err_final", "att_err_final", "mpc_cost_final", "alive_final", "alive_frac"):
        assert out[k] == pytest.approx(ref[k], abs=2e-5), k  # printed rounded to 5 places
    assert out["alive_frac"] == 1.0
    channels = [json.loads(ln)["ch"] for ln in (tmp_path / "t.jsonl").read_text().splitlines()]
    assert channels == ["mpc_time", "fleet"]


def test_run_scenario_falling_cat(capsys):
    out = _run(capsys, ["run_scenario", "--name", "falling_cat", "--f64"] + CPU)
    assert set(out) == {"final_cost", "constraint_violation", "attitude_error", "max_input",
                        "name", "closed_loop", "wall_s"}
    assert out["attitude_error"] < 1e-3 and out["max_input"] <= 8.0 + 1e-4
    with pytest.raises(SystemExit):
        tcli.main(["run_scenario", "--name", "no_such"] + CPU)


def test_run_actuated(capsys):
    out = _run(capsys, ["run_actuated", "--batch", "2", "--steps", "2", "--n_sub", "4"] + CPU)
    assert set(out) == {"steps", "batch", "wall_s", "compile_s", "vel_err_final",
                        "height_err_final", "mpc_cost_final", "alive_final", "alive_frac",
                        "solves_per_sec"}
    assert out["steps"] == 2 and out["batch"] == 2


def test_viz_forces_writes_a_png(capsys, tmp_path):
    png = tmp_path / "forces.png"
    out = _run(capsys, ["viz_forces", "--steps", "1", "--out", str(png)] + CPU)
    assert set(out) == {"frames", "out", "final_x", "alive"}
    assert out["frames"] == 1 and png.exists() and png.stat().st_size > 5000


def test_run_hardware_hands_the_loop_its_options(capsys, monkeypatch):
    from quaternion_mpc_tpu_torch.runtime import hardware_loop

    seen = {}
    monkeypatch.setattr(hardware_loop, "run_hardware_loopback",
                        lambda **kw: seen.update(kw) or {"upright": True})
    out = _run(capsys, ["run_hardware", "--duration", "0.5", "--est_rate", "250", "--pullers",
                        "2", "--no_auto_rate", "--walk", "1.0"] + CPU)
    assert out == {"upright": True}
    assert seen["duration_s"] == 0.5 and seen["est_rate"] == 250.0
    assert seen["async_pullers"] == 2 and seen["auto_rate"] is False and seen["walk_s"] == 1.0
    assert str(seen["device"]) == "cpu" and seen["mpc_rate"] == 50.0 and seen["low_rate"] == 250.0


def test_unknown_config_is_refused():
    with pytest.raises(SystemExit):
        tcli.main(["bench_solver", "--config", "no_such"] + CPU)


# ---------------------------------------------------------------------------
# The entry points' CUDA graphs (`utils.graphs`): what a graph's key names,
# and that on the CPU every entry point runs its function itself.
# ---------------------------------------------------------------------------

def _key_inputs(change):
    """A graphed function's arguments, with one thing a graph bakes in of
    them changed."""
    import torch

    x = torch.zeros((4, 3), dtype=torch.float32)
    w = torch.ones(3, dtype=torch.float32).expand(4, 3)
    lead = 0.0
    if change == "batch":
        x = torch.zeros((8, 3), dtype=torch.float32)
    elif change == "dtype":
        x = torch.zeros((4, 3), dtype=torch.float64)
    elif change == "device":
        x = torch.zeros((4, 3), dtype=torch.float32, device="meta")
    elif change == "strides":
        w = w.contiguous()
    elif change == "python_value":
        lead = 0.02
    elif change == "structure":
        lead = None
    return x, {"w": w, "lead": lead}


KEY_CHANGES = ["batch", "dtype", "device", "strides", "python_value", "structure"]


@pytest.mark.parametrize("change", KEY_CHANGES)
def test_graph_key_changes_with_everything_a_graph_bakes_in(change):
    from quaternion_mpc_tpu_torch.utils import graphs

    base = graphs.graph_key(_key_inputs(None))
    assert graphs.graph_key(_key_inputs(None)) == base  # new tensors, the same layouts
    assert graphs.graph_key(_key_inputs(change)) != base
    hash(graphs.graph_key(_key_inputs(change)))


@pytest.mark.parametrize("change", KEY_CHANGES)
def test_graphed_captures_once_for_each_signature(monkeypatch, change):
    """A `Graphed` keeps one capture for each signature of its inputs: new
    inputs of a signature it has seen replay that capture, a changed one is
    captured anew. (Capture itself needs the card: here a stand-in records
    it.)"""
    from quaternion_mpc_tpu_torch.utils import graphs

    made = []

    def capture(fn, args, label, generators):
        made.append(label)
        return fn

    monkeypatch.setattr(graphs, "on_card", lambda tree: True)
    monkeypatch.setattr(graphs, "CapturedCall", capture)
    g = graphs.Graphed(lambda x, d: x + 1, label="test")
    for inputs, captures in ((None, 1), (None, 1), (change, 2), (change, 2), (None, 2)):
        out = g(*_key_inputs(inputs))
        assert len(made) == captures and len(g.graphs) == captures
        assert out.shape == _key_inputs(inputs)[0].shape
    assert made == ["test", "test"]


def test_a_chained_graph_keys_its_state_by_shape_not_strides():
    """A chain of replays hands the step its own (dense) state buffers after
    the first call: the state's strides are not part of the key, its shape
    and dtype are."""
    import torch

    from quaternion_mpc_tpu_torch.utils import graphs

    args = (torch.zeros(3),)
    dense = graphs.graph_key(args, state=torch.zeros((4, 3)))
    assert graphs.graph_key(args, state=torch.zeros((3, 4)).T) == dense
    assert graphs.graph_key(args, state=torch.zeros((5, 3))) != dense
    assert graphs.graph_key(args, state=torch.zeros((4, 3), dtype=torch.float64)) != dense


@pytest.mark.parametrize("chain", [False, True], ids=["call", "chain"])
def test_graphed_runs_the_function_itself_on_the_cpu(chain):
    import torch

    from quaternion_mpc_tpu_torch.utils import graphs

    calls = []

    def fn(x, y):
        calls.append(1)
        return (x + y, y * 2) if chain else {"sum": x + y, "n": 3}

    g = graphs.Graphed(fn, chain=chain)
    x, y = torch.ones(2), torch.full((2,), 2.0)
    for _ in range(3):
        out = g(x, y)
        x = out[0] if chain else x
    assert len(calls) == 3 and g.graphs == {}
    assert torch.equal(out[0], torch.full((2,), 7.0)) if chain else out["n"] == 3


def _no_capture(monkeypatch):
    """Every capture raises: on the CPU no entry point may try one."""
    from quaternion_mpc_tpu_torch.utils import graphs

    def refuse(*args, **kwargs):
        raise AssertionError("a CUDA graph was captured for CPU tensors")

    monkeypatch.setattr(graphs, "CapturedCall", refuse)
    monkeypatch.setattr(graphs, "CapturedStep", refuse)


@pytest.mark.parametrize("argv", [
    ["bench_solver", "--batch", "2", "--iters", "1"],
    ["bench_solver", "--batch", "2", "--iters", "1", "--config", "gazebo_go1_convex_mpc"],
    ["run_standing", "--batch", "2", "--steps", "2", "--push", "20", "--push-at", "1"],
    ["run_trot", "--batch", "2", "--steps", "2", "--horizon", "4"],
    ["run_fleet", "--batch", "2", "--steps", "1", "--horizon", "4"],
    ["run_scenario", "--name", "spider_dog", "--closed_loop", "--steps", "1"],
], ids=["bench_quat", "bench_convex", "standing_push", "trot", "run_fleet", "receding"])
def test_entry_points_run_eagerly_on_the_cpu(capsys, monkeypatch, argv):
    _no_capture(monkeypatch)
    out = _run(capsys, argv + CPU)
    assert all(np.isfinite(v) for v in out.values() if isinstance(v, float))
