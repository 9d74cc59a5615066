"""CLI: run/info/convert/render subcommands end-to-end on CPU."""

import json
import pathlib

import numpy as np
import pytest

from n_body_problem_tpu.cli import main


def test_info(capsys):
    assert main(["info"]) == 0
    out = capsys.readouterr().out
    assert "solvers:" in out and "galaxy_20k" in out


def test_run_model_headless(tmp_path):
    rc = main([
        "run", "--model", "plummer", "--n", "256", "--steps", "20",
        "--solver", "direct", "--steps-per-block", "10",
        "--render-every", "10", "--diag-every", "10",
        "--checkpoint-every", "10", "--export-snap",
        "--width", "64", "--height", "48", "--out", str(tmp_path),
    ])
    assert rc == 0
    assert (tmp_path / "final.npz").exists()
    assert (tmp_path / "final.snap").exists()
    assert (tmp_path / "ck_00000010.npz").exists()
    frames = sorted((tmp_path / "frames").glob("*.png"))
    assert len(frames) == 2


def test_run_resume(tmp_path):
    main([
        "run", "--model", "plummer", "--n", "128", "--steps", "10",
        "--solver", "direct", "--out", str(tmp_path / "a"),
    ])
    rc = main([
        "run", "--resume", str(tmp_path / "a" / "final.npz"), "--steps", "5",
        "--solver", "direct", "--out", str(tmp_path / "b"),
    ])
    assert rc == 0
    from n_body_problem_tpu.io.checkpoint import load_checkpoint

    state, _ = load_checkpoint(tmp_path / "b" / "final.npz")
    assert int(state.step) == 15


def test_run_dataset_from_reference(tmp_path, reference_data_dir):
    rc = main([
        "run", "--dataset", "0", "--data-dir", str(reference_data_dir),
        "--steps", "2", "--solver", "blocked", "--steps-per-block", "2",
        "--out", str(tmp_path),
    ])
    assert rc == 0


def test_convert(tmp_path, reference_data_dir):
    dst = tmp_path / "o.csv"
    assert main(["convert", str(reference_data_dir / "galaxy_20K.bin"), str(dst)]) == 0
    assert dst.read_text().startswith("id,x,y,z,mass")


def test_render_from_checkpoint(tmp_path):
    main([
        "run", "--model", "disk_galaxy", "--n", "300", "--steps", "2",
        "--solver", "direct", "--out", str(tmp_path),
    ])
    png = tmp_path / "f.png"
    rc = main([
        "render", str(tmp_path / "final.npz"), str(png),
        "--width", "64", "--height", "48", "--cam-zoom", "4",
    ])
    assert rc == 0
    assert png.read_bytes()[:4] == b"\x89PNG"


def test_metrics_timer():
    from n_body_problem_tpu.utils.metrics import StepTimer

    t = StepTimer(n_bodies=100, window=5)
    t.start()
    t.stop(10)
    assert t.window_full
    s = t.snapshot()
    assert s["steps"] == 10 and s["pairs_per_sec"] > 0
    assert not t.window_full  # reset


def test_run_multichip_cpu_mesh(tmp_path):
    rc = main([
        "run", "--model", "plummer", "--n", "128", "--steps", "10",
        "--solver", "direct", "--devices", "4", "--strategy", "half_ring",
        "--morton-sort", "--out", str(tmp_path),
    ])
    assert rc == 0
    from n_body_problem_tpu.io.checkpoint import load_checkpoint

    state, _ = load_checkpoint(tmp_path / "final.npz")
    assert int(state.step) == 10


def test_config_file_physics_not_clobbered(tmp_path):
    """ADVICE r1 (medium): --config physics must survive argparse defaults."""
    cfg_file = tmp_path / "cfg.json"
    cfg_file.write_text(json.dumps({"dt": 0.002, "solver": "mxu", "eps2": 5e-7}))
    from n_body_problem_tpu.cli import build_parser, _build_config

    args = build_parser().parse_args([
        "run", "--config", str(cfg_file), "--steps", "1",
    ])
    cfg = _build_config(args)
    assert cfg.dt == 0.002 and cfg.solver == "mxu" and cfg.eps2 == 5e-7
    # Explicit flags still override the file.
    args = build_parser().parse_args([
        "run", "--config", str(cfg_file), "--dt", "0.004", "--steps", "1",
    ])
    cfg = _build_config(args)
    assert cfg.dt == 0.004 and cfg.solver == "mxu"


def test_resume_uses_checkpoint_config(tmp_path):
    """ADVICE r1 (low): --resume continues with the checkpoint's physics."""
    main([
        "run", "--model", "plummer", "--n", "128", "--steps", "5",
        "--solver", "direct", "--dt", "0.002", "--g", "2.0",
        "--out", str(tmp_path / "a"),
    ])
    rc = main([
        "run", "--resume", str(tmp_path / "a" / "final.npz"), "--steps", "5",
        "--out", str(tmp_path / "b"),
    ])
    assert rc == 0
    from n_body_problem_tpu.io.checkpoint import load_checkpoint

    _, cfg = load_checkpoint(tmp_path / "b" / "final.npz")
    assert cfg.dt == 0.002 and cfg.G == 2.0 and cfg.solver == "direct"


def test_auto_solver_resolution():
    """The execution plan, per platform: auto -> the all-pairs kernel and
    planned hierarchical lists on the GPU, the XLA matmul form and the
    dense treecode path on the CPU, an error anywhere else."""
    import pytest

    from n_body_problem_tpu.config import SimConfig
    from n_body_problem_tpu.plan import execution_plan

    gpu, cpu = execution_plan("gpu"), execution_plan("cpu")
    assert gpu.solver("auto") == "pallas" and gpu.near_kernel
    assert gpu.pair_kernel and gpu.tree_lists and not gpu.interpret
    assert cpu.solver("auto") == "mxu" and not cpu.near_kernel
    assert not cpu.pair_kernel and not cpu.tree_lists
    assert cpu.solver("direct") == gpu.solver("direct") == "direct"
    with pytest.raises(ValueError, match="GPU kernel"):
        cpu.solver("pallas")
    with pytest.raises(ValueError, match="no execution plan"):
        execution_plan("rocm")
    assert execution_plan() == cpu          # the test platform
    tree = SimConfig(solver="treecode")
    assert gpu.tree_variant(tree, 1 << 20) == "hier"
    assert gpu.tree_variant(tree.replace(tree_hier=False), 1 << 20) == "flat"
    assert gpu.tree_variant(tree, 1024) == "dense"        # < CHUNK_LANES
    assert cpu.tree_variant(tree, 1 << 20) == "dense"
    assert cpu.tree_variant(tree.replace(tree_flat_cap=64, tree_far_cap=64),
                            1 << 20) == "hier"
    assert cpu.tree_variant(tree.replace(tree_flat_cap=64), 1 << 20) == "flat"
