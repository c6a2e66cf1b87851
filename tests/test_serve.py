"""Serving layer: HTTP align endpoint + dynamic batcher.

Starts the ThreadingHTTPServer on an ephemeral port with the real
TpuAligner on the seeded tiny model (CPU backend here) and drives it
over actual HTTP, including concurrent requests that must coalesce into
one batch.
"""

import base64
import json
import threading
import urllib.error
import urllib.request

import numpy as np
import pytest

from soundswallower_tpu.aligner import TpuAligner
from soundswallower_tpu.serve import AlignService, make_server, segs_to_json


@pytest.fixture(scope="module")
def utt(tiny_model):
    """(audio, transcript) of a seeded utterance."""
    _, corpus = tiny_model
    return corpus.pair(np.random.default_rng(11), 2.5)


@pytest.fixture(scope="module")
def server(tiny_model, utt):
    al = TpuAligner(hmm=tiny_model[0])
    # prewarm the size-8 bucket on the main thread (what serve.py
    # --prewarm-text does): a cold CPU compile would otherwise land on
    # the first HTTP request's latency and time it out
    al.align_batch([utt[0]], [utt[1]])
    srv = make_server(al, "127.0.0.1", 0, max_batch=8, max_wait_ms=200.0)
    th = threading.Thread(target=srv.serve_forever, daemon=True)
    th.start()
    yield srv, al
    srv.shutdown()
    srv.service.close()


def _post(port, obj, path="/v1/align"):
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}{path}",
        data=json.dumps(obj).encode(),
        headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=600) as r:
        return r.status, json.loads(r.read())


def _get(port, path):
    with urllib.request.urlopen(
            f"http://127.0.0.1:{port}{path}", timeout=60) as r:
        return r.status, json.loads(r.read())


def test_health_and_config(server):
    srv, al = server
    port = srv.server_address[1]
    code, h = _get(port, "/v1/health")
    assert code == 200 and h["status"] == "ok"
    assert h["n_sen"] == al.am.n_sen
    code, cfg = _get(port, "/v1/config")
    assert code == 200 and cfg["feat"] == "1s_c_d_dd"


def test_align_endpoint(server, utt):
    srv, al = server
    port = srv.server_address[1]
    raw, text = utt
    code, res = _post(port, {
        "text": text,
        "audio": base64.b64encode(raw.tobytes()).decode()})
    assert code == 200
    assert res["t"] == text
    words = [w["t"] for w in res["w"] if not w["t"].startswith("<")]
    assert words == text.split()
    # word segs match the direct aligner path
    direct = segs_to_json(al.align(raw, text))
    assert res == direct
    # phone nesting present and contiguous within words
    for w in res["w"]:
        assert "w" in w
        assert abs(sum(p["d"] for p in w["w"]) - w["d"]) < 1e-6


def test_align_bad_requests(server):
    srv, _ = server
    port = srv.server_address[1]
    try:
        _post(port, {"text": "no audio"})
        assert False, "expected 400"
    except urllib.error.HTTPError as e:
        assert e.code == 400
    try:
        _post(port, {"text": "zzzunknownword",
                     "audio": base64.b64encode(b"\0\0" * 400).decode()})
        assert False, "expected 500"
    except urllib.error.HTTPError as e:
        assert e.code == 500


def test_batcher_coalesces(server, utt):
    """Concurrent same-transcript requests must run as ONE pipelined
    batch dispatch (align_batch_begin), not serial singles."""
    srv, al = server
    port = srv.server_address[1]
    raw, text = utt
    calls = []
    orig = al.align_batch_begin

    def spy(audios, texts, *a, **kw):
        calls.append(len(audios))
        return orig(audios, texts, *a, **kw)

    al.align_batch_begin = spy
    try:
        results = [None] * 4
        def hit(i):
            results[i] = _post(port, {
                "text": text,
                "audio": base64.b64encode(raw.tobytes()).decode()})
        threads = [threading.Thread(target=hit, args=(i,)) for i in range(4)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
    finally:
        al.align_batch_begin = orig
    assert all(r[0] == 200 for r in results)
    assert max(calls) >= 2, f"no batching happened: {calls}"


def test_responses_match_published_schema(server, utt):
    """The js/ client package's typed contract (js/index.d.ts): field
    sets and types of every endpoint response must match what the .d.ts
    declares — this test IS the schema check standing in for a node
    typecheck (no node runtime in this image)."""
    srv, _ = server
    port = srv.server_address[1]

    _, h = _get(port, "/v1/health")
    assert set(h) == {"status", "model", "n_sen", "backend"}
    assert h["status"] == "ok"
    assert isinstance(h["n_sen"], int) and isinstance(h["backend"], str)

    _, cfg = _get(port, "/v1/config")
    assert isinstance(cfg, dict) and "samprate" in cfg

    raw, text = utt
    _, out = _post(port, {
        "text": text,
        # exactly the bytes js/client.js puts on the wire: little-endian
        # int16 PCM, base64
        "audio": base64.b64encode(raw.astype("<i2").tobytes()).decode(),
    })

    def check_seg(seg, depth=0):
        assert {"b", "d", "t"} <= set(seg)
        assert set(seg) <= {"b", "d", "p", "t", "w"}  # p optional (.d.ts)
        for k in ("b", "d"):
            assert isinstance(seg[k], (int, float))
        assert isinstance(seg["t"], str)
        for child in seg.get("w", []):
            check_seg(child, depth + 1)

    check_seg(out)
    assert out["t"] == text
    words = [w["t"] for w in out["w"] if not w["t"].startswith("<")]
    assert words == text.split()
