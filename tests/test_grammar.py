"""Grammar tests: FSG model, text format, JSGF compilation."""

import numpy as np

from tests.conftest import DATADIR

from soundswallower_tpu.fsg import FsgModel
from soundswallower_tpu.jsgf import Jsgf
from soundswallower_tpu.logmath import LogMath

LMATH = LogMath(1.0001, 0, True)


def test_fsg_text_read(reference):
    fsg = FsgModel.read_fsg_file(f"{DATADIR}/goforward.fsg", LMATH, 6.5)
    assert fsg.n_state > 0
    assert "go" in fsg.vocab
    # null closure leaves reachable start->final path
    assert fsg.start_state != fsg.final_state or fsg.n_state == 1


def test_fsg_null_closure():
    fsg = FsgModel(None, LMATH, 1.0, 4)
    fsg.null_trans_add(0, 1, 0)
    fsg.null_trans_add(1, 2, 0)
    fsg.null_trans_add(2, 3, 0)
    fsg.null_trans_closure()
    assert 3 in fsg.null_trans[0]
    assert 2 in fsg.null_trans[0]


def test_fsg_silence_and_alt():
    fsg = FsgModel(None, LMATH, 6.5, 3)
    w = fsg.word_add("hello")
    fsg.trans_add(0, 1, 0, w)
    fsg.add_silence("<sil>", -1, 0.005)
    assert fsg.is_filler(fsg.word_id("<sil>"))
    # silence self-loop on every state
    for s in range(3):
        assert any(l.wid == fsg.word_id("<sil>") for l in fsg.trans[s].get(s, []))
    n = fsg.add_alt("hello", "hello(2)")
    assert n == 1
    assert fsg.is_alt(fsg.word_id("hello(2)"))


def test_jsgf_goforward(reference):
    g = Jsgf.parse_file(f"{DATADIR}/goforward.gram")
    assert g.name == "goforward"
    rule = g.get_rule("goforward.move")
    assert rule is not None and rule.is_public
    fsg = g.build_fsg(rule, LMATH, 6.5)
    assert set(fsg.vocab) == {"go", "forward", "ten", "meters"}
    # linear chain reachable start -> final through 4 words
    assert fsg.n_state >= 6


def test_jsgf_pizza_kleene_optional(reference):
    g = Jsgf.parse_file(f"{DATADIR}/pizza.gram")
    rule = g.default_rule()
    assert rule is not None
    fsg = g.build_fsg(rule, LMATH, 6.5)
    assert "pizza" in fsg.vocab
    assert "pepperoni" in fsg.vocab
    # optionals produce null transitions
    assert any(fsg.null_trans[s] for s in range(fsg.n_state))


def test_jsgf_weights_normalized():
    g = Jsgf.parse_string("""#JSGF V1.0;
grammar w;
public <r> = /0.8/ yes | /0.2/ no;
""")
    fsg = g.build_fsg(g.default_rule(), LMATH, 1.0)
    links = [l for s in range(fsg.n_state) for l in fsg.arcs(s) if l.wid >= 0]
    by_word = {fsg.word_str(l.wid): l.logs2prob for l in links}
    # weights normalized to 0.8/0.2; logs2prob = logmath_log(w) (no lw)
    assert abs(by_word["yes"] - LMATH.log(0.8)) <= 1
    assert abs(by_word["no"] - LMATH.log(0.2)) <= 1
