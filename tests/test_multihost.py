"""Multi-host glue: single-process degenerate behavior on the 8-device
CPU mesh (true multi-host runs need several machines; the global mesh +
local-data assembly path is what's exercised here), on the seeded tiny
model."""

import numpy as np

import jax
import jax.numpy as jnp

from soundswallower_tpu.parallel.multihost import (
    global_data_mesh, host_batch_to_global, initialize, local_results)


def test_global_mesh_and_assembly():
    initialize(None)  # no-op single process
    mesh = global_data_mesh()
    assert mesh.devices.size == len(jax.devices())
    B = mesh.devices.size * 2
    x = np.arange(B * 3, dtype=np.float32).reshape(B, 3)
    g = host_batch_to_global(mesh, x)
    assert g.shape == (B, 3)
    # a jitted step over the global mesh sees the full batch
    y = jax.jit(lambda a: a * 2)(g)
    back = local_results(y)
    assert (back == x * 2).all()


def test_mesh_align_batch_matches_single(tiny_model):
    """PRODUCT data-parallel path: align_batch over a ('data',) mesh of
    all local devices must give segments identical to the single-device
    path — same and mixed transcripts."""
    from soundswallower_tpu.aligner import TpuAligner
    from soundswallower_tpu.parallel.mesh import data_mesh

    corpus = tiny_model[1]
    rng = np.random.default_rng(41)
    raw, text = corpus.pair(rng, 1.5)
    al = TpuAligner(hmm=tiny_model[0])
    n = len(jax.devices())
    texts = [text] * n
    audios = [raw] * n
    base = al.align_batch(audios, texts)
    al.use_mesh(data_mesh(n))
    try:
        out = al.align_batch(audios, texts)
        assert all(o is not None for o in out)
        for a, b in zip(base, out):
            assert [(s.word, s.start, s.duration) for s in a] == \
                   [(s.word, s.start, s.duration) for s in b]
        # mixed transcripts (stacked per-row graphs sharded over 'data')
        mixed = [corpus.pair(rng, 1.5) for _ in range(n)]
        audios = [a for a, _ in mixed]
        mtexts = [t for _, t in mixed]
        al.use_mesh(None)
        mbase = al.align_batch(audios, mtexts)
        al.use_mesh(data_mesh(n))
        mout = al.align_batch(audios, mtexts)
        for a, b in zip(mbase, mout):
            assert (a is None) == (b is None)
            if a is not None:
                assert [(s.word, s.start, s.duration) for s in a] == \
                       [(s.word, s.start, s.duration) for s in b]
    finally:
        al.use_mesh(None)


def test_two_process_distributed(tmp_path, tiny_model):
    """REAL multi-process path: two OS processes, each with 2 CPU
    devices, form one 4-device global ('data',) mesh via
    jax.distributed.initialize; each host contributes its own local
    batch (host_batch_to_global), a jitted global step computes both a
    per-row transform and a cross-host reduction (the psum rides the
    distributed backend), and every process must see the global sum of
    BOTH hosts' data.  Then the PRODUCT pipeline: each host runs
    TpuAligner.align_batch over the global mesh with its own local
    utterances and must get segments identical to its single-device
    result (the aligner, not a toy reduction, crosses the process
    boundary)."""
    import json
    import os
    import socket
    import subprocess
    import sys

    # pick a free port for the coordinator
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()

    worker = tmp_path / "worker.py"
    worker.write_text(f'''
import json, sys
pid = int(sys.argv[1])
import numpy as np
import jax
import jax.numpy as jnp
sys.path.insert(0, {json.dumps(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))})
from soundswallower_tpu.parallel.multihost import (
    global_data_mesh, host_batch_to_global, initialize, local_results)
initialize("127.0.0.1:{port}", num_processes=2, process_id=pid)
assert jax.process_count() == 2, jax.process_count()
mesh = global_data_mesh()
assert mesh.devices.size == 4
# per-host local batch: host p contributes rows [p*4, p*4+4)
local = (np.arange(4 * 3, dtype=np.float32).reshape(4, 3)
         + pid * 12.0)
g = host_batch_to_global(mesh, local)
assert g.shape == (8, 3)
doubled = jax.jit(lambda a: a * 2)(g)
total = jax.jit(jnp.sum)(g)          # cross-host reduction
back = local_results(doubled)

# product pipeline across the process boundary: per-host local
# utterances, global ('data',) mesh, results equal single-device
from soundswallower_tpu.aligner import TpuAligner
from soundswallower_tpu.seeded_model import Corpus
raw, text = Corpus({json.dumps(tiny_model[0])}).pair(
    np.random.default_rng(42 + pid), 1.5)
al = TpuAligner(hmm={json.dumps(tiny_model[0])})
texts = [text] * 2
ref = al.align_batch([raw, raw], texts)          # single-device
al.use_mesh(mesh)                                 # global 4-dev mesh
got = al.align_batch([raw, raw], texts)
align_ok = all(
    r is not None and g_ is not None and
    [(s.word, s.start, s.duration) for s in r] ==
    [(s.word, s.start, s.duration) for s in g_]
    for r, g_ in zip(ref, got))

out = dict(pid=pid, total=float(total),
           back_ok=bool((back == local * 2).all()),
           align_ok=bool(align_ok))
print("RESULT " + json.dumps(out))
''')
    procs = [
        subprocess.Popen(
            [sys.executable, str(worker), str(i)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
            env={**os.environ, "JAX_PLATFORMS": "cpu",
                 "XLA_FLAGS": "--xla_force_host_platform_device_count=2"})
        for i in range(2)
    ]
    outs = []
    for p in procs:
        out, _ = p.communicate(timeout=300)
        assert p.returncode == 0, out[-2000:]
        line = [ln for ln in out.splitlines() if ln.startswith("RESULT ")]
        assert line, out[-2000:]
        outs.append(json.loads(line[-1][len("RESULT "):]))
    want_total = float(np.arange(24, dtype=np.float32).sum())
    for o in outs:
        assert o["back_ok"], o
        assert o["total"] == want_total, (o, want_total)
        assert o["align_ok"], o


def test_mesh_decode_batch_matches_single(tiny_model):
    """Grammar decode_batch over the ('data',) mesh == single-device."""
    from soundswallower_tpu.aligner import TpuAligner
    from soundswallower_tpu.parallel.mesh import data_mesh

    corpus = tiny_model[1]
    rng = np.random.default_rng(43)
    w = corpus.words[:4]
    raw = corpus.audio(f"{w[0]} {w[2]}", rng)
    al = TpuAligner(hmm=tiny_model[0])
    al.set_grammar(jsgf_string=(
        f"#JSGF V1.0;\ngrammar g;\npublic <g> = ( {w[0]} | {w[1]} ) "
        f"( {w[2]} | {w[3]} ) ;\n"))
    n = len(jax.devices())
    base = al.decode_batch([raw] * n)
    al.use_mesh(data_mesh(n))
    try:
        out = al.decode_batch([raw] * n)
    finally:
        al.use_mesh(None)
    assert all(o is not None for o in out)
    for (h1, s1), (h2, s2) in zip(base, out):
        assert h1 == h2 == f"{w[0]} {w[2]}"
        assert [(s.word, s.start, s.duration) for s in s1] == \
               [(s.word, s.start, s.duration) for s in s2]
