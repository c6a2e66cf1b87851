"""The seeded model writer, the binary mdef writer, and where the
package puts JAX's compile cache."""

import json
import os
import subprocess
import sys

import numpy as np
import pytest

from soundswallower_tpu import s3file as s3
from soundswallower_tpu.mdef import BinMdef
from soundswallower_tpu.seeded_model import (CI_PHONES, PRESETS,
                                              write_seeded_model)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_tiny_loads_through_acoustic_model(tiny_model):
    from soundswallower_tpu.am import AcousticModel
    from soundswallower_tpu.config import Config

    cfg = Config(hmm=tiny_model[0])
    cfg.expand()
    am = AcousticModel.load(cfg)
    p = PRESETS["tiny"]
    assert am.backend == "ptm"
    assert am.mdef.n_phone == p["n_phone"] and am.n_sen == p["n_sen"]
    assert am.mdef.n_sseq == p["n_sseq"]
    assert am.means.shape == (42, 3, 128, 13)
    assert am.mixw_cb is not None                 # 4-bit clustered
    # PTM: every senone scores with its base phone's codebook
    m = am.mdef
    base = m._pid2ci[np.arange(m.n_phone)]
    sens = m.sseq[m.phone_ssid]                   # [n_phone, 3]
    assert (am.sen2cb[sens] == base[:, None]).all()
    assert (cfg["lowerf"], cfg["upperf"], cfg["nfilt"]) == (130, 3700, 20)
    assert cfg["svspec"] == "0-12/13-25/26-38"


@pytest.mark.parametrize("preset", ["tiny", "en-us"])
def test_headers_report_the_preset_counts(preset):
    d = write_seeded_model(preset, 0)
    p = PRESETS[preset]
    m = BinMdef(os.path.join(d, "mdef"))
    assert (m.n_ciphone, m.n_phone, m.n_sen, m.n_ci_sen, m.n_sseq,
            m.n_tmat, m.n_emit_state) == (
        len(CI_PHONES), p["n_phone"], p["n_sen"], 126, p["n_sseq"], 42, 3)
    assert m.ciname == list(CI_PHONES)
    means, n_mgau, n_feat, n_density, veclen = s3.read_gauden_params(
        os.path.join(d, "means"))
    assert (n_mgau, n_feat, n_density, veclen) == (42, 3, 128, [13] * 3)
    assert (s3.read_gauden_params(os.path.join(d, "variances"))[0] > 0).all()
    assert s3.read_tmat_params(
        os.path.join(d, "transition_matrices")).shape == (42, 3, 4)
    mixw, cb = s3.read_sendump(os.path.join(d, "sendump"), 3, 128,
                               p["n_sen"])
    assert cb is not None and mixw.shape == (3, 128, (p["n_sen"] + 1) // 2)
    with open(os.path.join(d, "dict.txt")) as fh:
        lines = fh.read().splitlines()
    assert len(lines) == p["n_words"]
    assert any(ln.split()[0].endswith("(2)") for ln in lines)
    fillers = {"SIL", "+NSN+", "+SPN+"}
    for ln in lines[:2000]:
        prons = ln.split()[1:]
        assert 2 <= len(prons) <= 12 and not fillers & set(prons)


def test_cd_tree_lookup_round_trips(tiny_model):
    """Every triphone the writer put in the tree is found again by the
    reader's cd_tree walk."""
    m = BinMdef(os.path.join(tiny_model[0], "mdef"))
    for pid in range(m.n_ciphone, m.n_phone):
        wpos, b, lc, rc = (int(x) for x in m.phone_info[pid])
        assert m.phone_id(b, lc, rc, wpos) == pid


def test_writer_is_deterministic_and_reused(tmp_path, tiny_model):
    d = write_seeded_model("tiny", 0, outdir=str(tmp_path / "again"))
    for name in ("mdef", "means", "variances", "sendump", "dict.txt",
                 "feat_params.json"):
        with open(os.path.join(d, name), "rb") as a, \
                open(os.path.join(tiny_model[0], name), "rb") as b:
            assert a.read() == b.read(), name
    stamp = os.path.getmtime(os.path.join(d, "mdef"))
    assert write_seeded_model("tiny", 0, outdir=d) == d
    assert os.path.getmtime(os.path.join(d, "mdef")) == stamp


def test_corpus_audio_and_transcripts(tiny_model):
    d, corpus = tiny_model
    rng = np.random.default_rng(0)
    audio, text = corpus.pair(rng, 2.0)
    assert audio.dtype == np.int16 and len(audio) >= 2.0 * 16000 * 0.9
    assert all(w in corpus.words for w in text.split())
    padded = corpus.audio(text, rng, seconds=6.0)
    assert len(padded) == 600 * 160
    with open(os.path.join(d, "audio", "transcripts.txt")) as fh:
        name, words = fh.readline().split(" ", 1)
    assert os.path.exists(os.path.join(d, "audio", name))
    assert all(w in corpus.words for w in words.split())


def test_cmninit_is_the_training_mean(tiny_model):
    with open(os.path.join(tiny_model[0], "feat_params.json")) as fh:
        fp = json.load(fh)
    assert len(fp["cmninit"].split(",")) == 13


@pytest.mark.parametrize("env_dir", [None, "custom"])
def test_compile_cache_placement(tmp_path, env_dir):
    """Without JAX_COMPILATION_CACHE_DIR the package sets one fixed,
    git-ignored path in the checkout; with it, JAX's own setting stands
    and the package sets nothing."""
    env = {k: v for k, v in os.environ.items()
           if k != "JAX_COMPILATION_CACHE_DIR"}
    env["JAX_PLATFORMS"] = "cpu"
    want = os.path.join(REPO, ".jax_cache")
    if env_dir:
        want = env["JAX_COMPILATION_CACHE_DIR"] = str(tmp_path / env_dir)
    out = subprocess.run(
        [sys.executable, "-c",
         "import soundswallower_tpu, jax; "
         "print(jax.config.jax_compilation_cache_dir)"],
        capture_output=True, text=True, timeout=120, env=env, cwd=REPO,
        check=True).stdout.strip().splitlines()[-1]
    assert out == want
    if not env_dir:
        with open(os.path.join(REPO, ".gitignore")) as fh:
            assert ".jax_cache/" in fh.read().split()
