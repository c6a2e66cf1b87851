"""Host foundation tests: logmath, model file readers, dict, dict2pid."""

import numpy as np

from tests.conftest import MODELDIR

from soundswallower_tpu.logmath import LogMath, SENSCR_SHIFT
from soundswallower_tpu.mdef import BinMdef
from soundswallower_tpu.dictionary import Dictionary
from soundswallower_tpu.dict2pid import Dict2Pid
from soundswallower_tpu import s3file as s3


def test_logmath_basics():
    lm = LogMath(1.0001, 0, True)
    # reference: logmath_log(1e-48) with base 1.0001 (values verified
    # against the C library: beam = 1e-48 -> -1105359 >> 10 = -1080)
    assert lm.log(1.0) == 0
    b = lm.log(1e-48) >> SENSCR_SHIFT
    assert b == -1080
    assert lm.log(7e-29) >> SENSCR_SHIFT == -634
    # add: log(x)+log(x) == log(2x) within table quantization
    x = lm.log(0.5)
    assert abs(lm.add(x, x) - lm.log(1.0)) <= 1


def test_logmath_8bit_table():
    lm8 = LogMath(1.0001, SENSCR_SHIFT, True)
    assert lm8.width == 1
    assert lm8.table_size == 256
    assert lm8.table[0] == 7  # log_1.0001(2) >> 10
    assert lm8.fast_add(0, 0) == -7


def test_mdef_counts(reference):
    m = BinMdef(f"{MODELDIR}/en-us/mdef")
    assert (m.n_ciphone, m.n_phone, m.n_sen, m.n_sseq) == (42, 137095, 5126, 28458)
    assert m.n_emit_state == 3
    assert m.ciphone_str(m.silphone) == "SIL"
    fr = BinMdef(f"{MODELDIR}/fr-fr/mdef")
    assert (fr.n_ciphone, fr.n_phone, fr.n_sen) == (36, 97057, 2108)


def test_gauden_read(reference):
    means, n_mgau, n_feat, n_dens, veclen = s3.read_gauden_params(
        f"{MODELDIR}/en-us/means")
    assert (n_mgau, n_feat, n_dens) == (42, 3, 128)
    assert veclen == [13, 13, 13]
    assert means.dtype == np.float32


def test_dict(en_us):
    am, cfg = en_us
    d = Dictionary(am.mdef, cfg["dict"], cfg["fdict"])
    wid = d.wordid("go")
    assert [am.mdef.ciphone_str(p) for p in d.prons[wid]] == ["G", "OW"]
    # special words live in the filler range
    assert d.filler_word(d.silwid)
    assert not d.real_word(d.startwid)
    assert d.real_word(wid)
    # alternates: "was(2)" chains off "was"
    was = d.wordid("was")
    alt = d.nextalt(was)
    assert alt >= 0 and d.basestr(alt) == "was"


def test_dict2pid(en_us):
    am, cfg = en_us
    d = Dictionary(am.mdef, cfg["dict"], cfg["fdict"])
    d2p = Dict2Pid(am.mdef, d)
    # word-initial triphone for "go" with SIL left context must be a
    # valid ssid that differs from the CI ssid in general
    g = am.mdef.ciphone_id("G")
    ow = am.mdef.ciphone_id("OW")
    ssid = int(d2p.ldiph_lc[g, ow, am.mdef.silphone])
    assert 0 <= ssid < am.mdef.n_sseq
    # rssid compression invariants
    x = d2p.get_rssid(ow, g)
    assert x.n_ssid >= 1
    assert (x.cimap >= 0).all() and (x.cimap < x.n_ssid).all()


def test_tmat_quantization(en_us):
    am, _ = en_us
    assert am.tmat.shape == (42, 3, 4)
    # upper-triangular with <=1 skip: [i][j]==255 for j<i and j>i+2
    assert (am.tmat[:, 1, 0] == 255).all()
    assert (am.tmat[:, 2, 0] == 255).all()
    assert (am.tmat[:, 2, 1] == 255).all()
