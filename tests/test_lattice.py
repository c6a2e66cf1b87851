"""Lattice / bestpath / posterior / A*-nbest parity vs the C reference.

Golden data (tests/golden/lattice-goforward) comes from
tools/oracle/lattice_oracle.c: the reference decodes goforward.raw with
goforward.gram in compallsen mode and dumps the senone scores its search
consumed PLUS the resulting lattice, bestpath hyp, norm, per-link
alpha/beta/posterior, and the first 20 A* paths.  Feeding the same
scores into our FsgSearch must reproduce every one of those numbers
(ps_lattice.c:759 bestpath, :921 posterior, :1167-1246 A*)."""

import numpy as np
import pytest

from tests.conftest import DATADIR, GOLDEN, golden

from soundswallower_tpu.lattice import AstarSearch, Lattice

NAME = "lattice-goforward"


@pytest.fixture(scope="module")
def fsg_run(en_us_mod):
    """Run the exact FSG beam search over the golden compallsen scores."""
    am, cfg = en_us_mod
    from soundswallower_tpu.dict2pid import Dict2Pid
    from soundswallower_tpu.dictionary import Dictionary
    from soundswallower_tpu.jsgf import Jsgf
    from soundswallower_tpu.logmath import LogMath
    from soundswallower_tpu.search_fsg import FsgSearch

    lmath = LogMath(cfg.get_float("logbase"), 0, True)
    d = Dictionary(am.mdef, cfg["dict"], cfg["fdict"], cfg.get_bool("dictcase"))
    d2p = Dict2Pid(am.mdef, d)
    j = Jsgf.parse_file(f"{DATADIR}/goforward.gram")
    fsg = j.build_fsg(j.default_rule(), lmath, cfg.get_float("lw"))
    search = FsgSearch(fsg, cfg, am, d, d2p, lmath)
    senscr = golden(NAME, "senscr.i16", np.int16, (-1, am.n_sen))
    search.start()
    for t in range(len(senscr)):
        search.step(senscr[t], t)
    search.finish()
    return search, cfg


@pytest.fixture(scope="module")
def en_us_mod(reference):
    import os

    from soundswallower_tpu.am import AcousticModel
    from soundswallower_tpu.config import Config

    cfg = Config(hmm="/root/reference/model/en-us")
    cfg.expand()
    return AcousticModel.load(cfg), cfg


def _golden_lattice():
    nodes, links = [], []
    for line in open(f"{GOLDEN}/{NAME}/lattice.txt"):
        f = line.split()
        if f[0] == "NODE":
            nodes.append((f[1], int(f[2]), int(f[3]), int(f[4]), int(f[5])))
        elif f[0] == "LINK":
            links.append(tuple(int(x) for x in f[1:]))
    return nodes, links


def _node_key(dag, n):
    w = dag.dict.wordstr(n.wid) if n.wid >= 0 else "?"
    return (w, n.sf, n.fef, n.lef, n.node_id)


def test_lattice_structure_matches_reference(fsg_run):
    """Nodes and links (with acoustic scores and end frames) equal the
    C DAG (fsg_search_lattice, fsg_search.c:1344-1524)."""
    search, cfg = fsg_run
    dag = Lattice.from_fsg_search(search, cfg)
    assert dag is not None
    g_nodes, g_links = _golden_lattice()
    ours = sorted(_node_key(dag, n) for n in dag.nodes)
    assert ours == sorted(g_nodes)
    # links keyed by (from_key_no_ef, to_key_no_ef, ascr, ef); golden
    # links reference node indices in dump order
    def nk(i):
        w, sf, fef, lef, nid = g_nodes[i]
        return (w, sf, nid)

    want = sorted((nk(a), nk(b), ascr, ef) for a, b, ascr, ef in g_links)
    got = sorted(((dag.dict.wordstr(l.src.wid), l.src.sf, l.src.node_id),
                  (dag.dict.wordstr(l.dst.wid), l.dst.sf, l.dst.node_id),
                  l.ascr, l.ef)
                 for n in dag.nodes for l in n.exits)
    assert got == want


def test_bestpath_posterior_match_reference(fsg_run):
    """Forward bestpath hyp, the normalizer, and every link's
    alpha/beta/posterior equal the C values (lattice_bestpath
    ps_lattice.c:759, lattice_posterior :921, ps_latlink_prob)."""
    search, cfg = fsg_run
    dag = Lattice.from_fsg_search(search, cfg)
    ascale = cfg.get_float("ascale")
    lines = open(f"{GOLDEN}/{NAME}/bestpath.txt").read().splitlines()
    want_hyp = lines[0]
    _, want_norm, _, want_post = lines[1].split()
    best = dag.bestpath(ascale)
    assert best is not None
    assert dag.hyp(best) == want_hyp
    assert dag.norm == int(want_norm)
    post = dag.posterior(ascale)
    assert post == int(want_post)
    g_nodes, _ = _golden_lattice()

    def nk(i):
        w, sf, fef, lef, nid = g_nodes[i]
        return (w, sf, nid)

    want_links = {}
    for line in lines[2:]:
        f = line.split()
        assert f[0] == "LINKPOST"
        want_links[(nk(int(f[1])), nk(int(f[2])))] = (
            int(f[3]), int(f[4]), int(f[5]))
    for n in dag.nodes:
        for l in n.exits:
            key = ((dag.dict.wordstr(l.src.wid), l.src.sf, l.src.node_id),
                   (dag.dict.wordstr(l.dst.wid), l.dst.sf, l.dst.node_id))
            lp, alpha, beta = want_links[key]
            assert l.alpha == alpha, key
            assert l.beta == beta, key
            assert l.alpha + l.beta - dag.norm == lp, key


def test_astar_nbest_matches_reference(fsg_run):
    """A* N-best paths: same scores, same hyps, same order
    (astar_search_start/next/hyp, ps_lattice.c:1167-1290)."""
    search, cfg = fsg_run
    dag = Lattice.from_fsg_search(search, cfg)
    dag.bestpath(cfg.get_float("ascale"))  # C runs astar after bestpath
    want = [(int(s), h) for s, h in
            (line.split("\t") for line in
             open(f"{GOLDEN}/{NAME}/nbest.txt").read().splitlines())]
    astar = AstarSearch(dag)
    got = []
    for _ in range(len(want)):
        p = astar.next()
        if p is None:
            break
        got.append((p.score, astar.hyp(p)))
    assert got == want


def test_segs_match_reference(fsg_run):
    """First-pass FSG backtrace segs equal the C dump."""
    search, _ = fsg_run
    want = []
    for line in open(f"{GOLDEN}/{NAME}/segs.txt"):
        w, sf, ef, ascr, lscr = line.split()
        want.append((w, int(sf), int(ef), int(ascr), int(lscr)))
    got = [(s["word"] if s["word"] is not None else "(NULL)",
            s["sf"], s["ef"], s["ascr"], s["lscr"])
           for s in search.seg_iter()]
    assert got == want


def test_nbest_from_device_fast_path(reference):
    """nbest/lattice WITHOUT the slow exact decoder (    7): device dense scoring (bit-exact compallsen) + the host
    history-table beam search.  The golden lattice/nbest were dumped
    by the C in compallsen mode on the same audio, so every hyp and
    score matches exactly."""
    from soundswallower_tpu.aligner import TpuAligner

    al = TpuAligner(hmm="/root/reference/model/en-us")
    al.set_grammar(jsgf_file=f"{DATADIR}/goforward.gram")
    raw = np.fromfile(f"{DATADIR}/goforward.raw", np.int16)
    want = [(int(s), h) for s, h in
            (line.split("\t") for line in
             open(f"{GOLDEN}/{NAME}/nbest.txt").read().splitlines())]
    got = []
    for hyp, score in al.nbest(raw):
        got.append((score, hyp))
        if len(got) >= len(want):
            break
    assert got == want
    # the history search's own hyp agrees with the dense decode
    search = al.decode_search(raw)
    assert search.hyp()[0] == "go forward ten meters"
