"""chip_smoke.py on the CPU: the phase functions at the tiny seeded
model (main() is only bypassed by calling the phases directly), and
main()'s refusal to run without a GPU."""

import os
import subprocess
import sys

import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import chip_smoke  # noqa: E402

SMALL = chip_smoke.Sizes(batch=12, min_s=1.0, max_s=4.0, fe_rows=2, mixed=8,
                         mixed_s=3.0, dense_s=3.0, long_s=20.0,
                         grammar_rows=3, requests=4, sample_rows=2,
                         score_frames=40, timing_reps=1)


@pytest.fixture(scope="module")
def ctx(tiny_model):
    al, corpus, d = chip_smoke.phase_model("tiny", 0)
    # the tiny model's transcripts reach few of its senones; a lower
    # union limit lets a small batch cross into dense scoring
    al.UNION_MAX_FRAC = 0.4
    return chip_smoke.Ctx(al, corpus, np.random.default_rng(3), SMALL, d)


def test_phase_model_shapes(ctx):
    shapes = chip_smoke.loaded_shapes(ctx.al)
    assert shapes["n_ciphone"] == 42 and shapes["n_emit_state"] == 3
    assert shapes["codebooks"] == (42, 3, 128, 13)
    assert ctx.al.fe_route == "host"


def test_phases_same_mixed_compare(ctx):
    chip_smoke.phase_same(ctx)
    chip_smoke.phase_mixed(ctx)
    chip_smoke.phase_compare(ctx)
    assert ctx.al._uni["dense"]


@pytest.mark.parametrize("phase", ["longform", "grammar", "serve"])
def test_phase(ctx, phase):
    getattr(chip_smoke, f"phase_{phase}")(ctx)


def test_phase_four_on_virtual_devices(ctx):
    """The --four path rehearsed on 4 of the virtual CPU devices."""
    sz = chip_smoke.Sizes(batch=8, min_s=1.0, max_s=3.0, mixed=8,
                          mixed_s=3.0, long_s=8.0)
    four = chip_smoke.Ctx(ctx.al, ctx.corpus, np.random.default_rng(4), sz,
                          ctx.model_dir)
    chip_smoke.phase_four(four, 4)


@pytest.mark.gpu
def test_phases_on_gpu(gpu, tiny_model):
    """The tiny-preset phases on the card, with the GPU-vs-CPU scorer and
    Viterbi comparisons of phase 8 (chip tier: skips without a GPU)."""
    al, corpus, d = chip_smoke.phase_model("tiny", 0)
    al.UNION_MAX_FRAC = 0.4
    c = chip_smoke.Ctx(al, corpus, np.random.default_rng(5), SMALL, d)
    for phase in ("same", "mixed", "compare"):
        getattr(chip_smoke, f"phase_{phase}")(c)


def test_main_refuses_without_gpu():
    env = {k: v for k, v in os.environ.items() if k != "XLA_FLAGS"}
    env["JAX_PLATFORMS"] = "cpu"
    r = subprocess.run([sys.executable, os.path.join(REPO, "chip_smoke.py")],
                       capture_output=True, text=True, timeout=300, env=env,
                       cwd=REPO)
    assert r.returncode != 0
    assert "no GPU found" in r.stderr
    assert '"ok"' not in r.stdout


def test_main_refuses_outside_a_checkout(tmp_path):
    import shutil

    shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path)
    r = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path,
                       capture_output=True, text=True, timeout=300,
                       env={**os.environ, "JAX_PLATFORMS": "cpu"})
    assert r.returncode != 0
    assert '"ok"' not in r.stdout
