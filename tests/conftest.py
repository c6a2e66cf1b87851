"""Test configuration and the three test tiers.

1. CPU tests on the seeded models (``tiny_model``): the package writes
   a small model with the published structure from a seed
   (soundswallower_tpu/seeded_model.py), so these need nothing outside
   the repository.  Tests run on the CPU backend with 8 virtual devices
   so the mesh tests work without accelerators.
2. C-oracle golden tests: they compare with the reference C library's
   outputs (tests/golden/) and need the reference model checkout at
   MODELDIR; without it the ``reference`` fixture skips them.
3. Chip tests, marked ``gpu``: they skip here (the ``gpu`` fixture
   decides) and run on a machine with a card (``python -m pytest -m gpu
   tests/``); ``python chip_smoke.py`` is the end-to-end run there.

Whether a test skips is decided inside a fixture, never at import or
collection, so every xdist worker collects the same tests.

Slow full-decode parity tests only run when SST_SLOW=1 (they re-run the
complete exact two-pass pipeline, several minutes each).
"""

import os

# CPU unless the caller chose a platform (chip tests: run
# `python -m pytest -m gpu tests/` on a machine with a GPU)
os.environ.setdefault("JAX_PLATFORMS", "cpu")
xla_flags = os.environ.get("XLA_FLAGS", "")
if "host_platform_device_count" not in xla_flags:
    os.environ["XLA_FLAGS"] = (
        xla_flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import numpy as np  # noqa: E402
import pytest  # noqa: E402

GOLDEN = os.path.join(os.path.dirname(__file__), "golden")
MODELDIR = "/root/reference/model"
DATADIR = "/root/reference/tests/data"


@pytest.fixture(scope="session")
def reference():
    """The reference model checkout the golden tests compare against."""
    if not os.path.isdir(os.path.join(MODELDIR, "en-us")):
        pytest.skip("reference model checkout absent (golden-oracle tier)")
    return MODELDIR


@pytest.fixture
def gpu():
    """A GPU device for chip tests; skips on CPU-only machines."""
    import jax

    devs = [d for d in jax.devices() if d.platform == "gpu"]
    if not devs:
        pytest.skip("needs a GPU (chip tier)")
    return devs[0]


@pytest.fixture(scope="session")
def tiny_model():
    """(model_dir, Corpus) of the seeded tiny model."""
    from soundswallower_tpu.seeded_model import Corpus, write_seeded_model

    d = write_seeded_model("tiny", 0)
    return d, Corpus(d)


@pytest.fixture(scope="session")
def tiny_aligner(tiny_model):
    from soundswallower_tpu.aligner import TpuAligner

    return TpuAligner(hmm=tiny_model[0])


slow = pytest.mark.skipif(
    not os.environ.get("SST_SLOW"), reason="set SST_SLOW=1 for slow parity tests"
)


@pytest.fixture(scope="session")
def en_us(reference):
    from soundswallower_tpu.config import Config
    from soundswallower_tpu.am import AcousticModel

    cfg = Config(hmm=os.path.join(MODELDIR, "en-us"))
    cfg.expand()
    return AcousticModel.load(cfg), cfg


@pytest.fixture(scope="session")
def fr_fr(reference):
    from soundswallower_tpu.config import Config
    from soundswallower_tpu.am import AcousticModel

    cfg = Config(hmm=os.path.join(MODELDIR, "fr-fr"))
    cfg.expand()
    return AcousticModel.load(cfg), cfg


@pytest.fixture(scope="session")
def ms_en(reference, tmp_path_factory):
    """en-us forced into the fully-continuous (ms) backend via a
    synthesized senmgau map + float mixture weights (see
    tools/make_ms_model.py; goldens in tests/golden/ms-en were produced
    by the C oracle against the same synthesized files)."""
    import sys

    sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "tools"))
    from make_ms_model import make_ms_model

    from soundswallower_tpu.am import AcousticModel
    from soundswallower_tpu.config import Config

    outdir = str(tmp_path_factory.mktemp("ms-model"))
    mixw, senmgau = make_ms_model(os.path.join(MODELDIR, "en-us"), outdir)
    cfg = Config(hmm=os.path.join(MODELDIR, "en-us"),
                 senmgau=senmgau, mixw=mixw)
    cfg.expand()
    return AcousticModel.load(cfg), cfg


@pytest.fixture(scope="session")
def sendump_4b(reference, tmp_path_factory):
    """Deterministic 4-bit clustered sendump synthesized from the stock
    en-us 8-bit one (tools/make_4b_sendump.py; goldens in
    tests/golden/ptm4b-en and semi4b-en were produced by the C oracle
    against this exact file)."""
    import sys

    sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "tools"))
    from make_4b_sendump import make_4b_sendump

    out = str(tmp_path_factory.mktemp("sendump4b") / "sendump")
    return make_4b_sendump(os.path.join(MODELDIR, "en-us"), out)


@pytest.fixture(scope="session")
def ptm_4b_en(sendump_4b):
    """en-us PTM backend with the synthesized 4-bit clustered sendump
    (exercises ptm_mgau.c:377's packed-byte-parity nibble decode)."""
    from soundswallower_tpu.am import AcousticModel
    from soundswallower_tpu.config import Config

    cfg = Config(hmm=os.path.join(MODELDIR, "en-us"), sendump=sendump_4b)
    cfg.expand()
    return AcousticModel.load(cfg), cfg


@pytest.fixture(scope="session")
def semi_4b_en(sendump_4b, tmp_path_factory):
    """Semi-continuous backend with the 4-bit clustered sendump
    (exercises s2_semi_mgau.c:475-499's senone-index-parity decode and
    the uint8 w_den wraparound, :452-461)."""
    import sys

    sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "tools"))
    from make_semi_model import make_semi_model

    from soundswallower_tpu.am import AcousticModel
    from soundswallower_tpu.config import Config

    outdir = str(tmp_path_factory.mktemp("semi4b-model"))
    mean, var = make_semi_model(os.path.join(MODELDIR, "en-us"), outdir)
    cfg = Config(hmm=os.path.join(MODELDIR, "en-us"), mean=mean, var=var,
                 sendump=sendump_4b)
    cfg.expand()
    return AcousticModel.load(cfg), cfg


@pytest.fixture(scope="session")
def semi_en(reference, tmp_path_factory):
    """en-us forced into the semi-continuous backend via a synthesized
    single-codebook means/variances pair (see tools/make_semi_model.py;
    goldens in tests/golden/semi-en were produced by the C oracle against
    the same synthesized files — acmod's fallback chain selects
    s2_semi_mgau when n_mgau == 1)."""
    import sys

    sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "tools"))
    from make_semi_model import make_semi_model

    from soundswallower_tpu.am import AcousticModel
    from soundswallower_tpu.config import Config

    outdir = str(tmp_path_factory.mktemp("semi-model"))
    mean, var = make_semi_model(os.path.join(MODELDIR, "en-us"), outdir)
    cfg = Config(hmm=os.path.join(MODELDIR, "en-us"), mean=mean, var=var)
    cfg.expand()
    return AcousticModel.load(cfg), cfg


def golden(name: str, fname: str, dtype, shape=None):
    arr = np.fromfile(os.path.join(GOLDEN, name, fname), dtype=dtype)
    if shape is not None:
        arr = arr.reshape(shape)
    return arr
