"""Seeded acoustic models and audio at the published model widths.

``write_seeded_model`` writes a complete model directory from a seed,
in the formats ``Config.expand``, ``mdef.py`` and ``s3file.py`` read:
binary ``mdef``, ``means``/``variances``, ``transition_matrices``, a
4-bit clustered ``sendump``, ``feat_params.json``, ``dict.txt`` and
``noisedict.txt``, plus a few seeded WAV utterances with their
transcripts.  Nothing comes from outside the repository.

The ``en-us`` preset copies the shapes of the published en-us model
(BASELINE.md): 42 CI phones, 137,095 phones, 5,126 senones (126 CI),
28,458 senone sequences of 3 emitting states, one tmat per CI phone, a
PTM codebook per CI phone of 3 streams x 128 Gaussians x 13 dims, and a
134,784-entry dictionary.  The ``tiny`` preset has the same structure
and scorer widths at a few hundred phones and words, for CPU tests.

The weights are not uniform noise.  Every CI phone gets a seeded
"sound" (three formant sinusoids plus a noise share; silence is
near-quiet noise), and each codebook's Gaussians are fitted to the
front end's features of that phone's sound in a seeded training
utterance.  Audio synthesized from a transcript with ``Corpus`` is
therefore aligned to meaningful boundaries, which keeps comparisons
between scoring paths about alignments rather than about ties.

The output goes to ``<checkout>/.seeded/<preset>-<seed>`` (git-ignored)
and is reused when it is already there.
"""

from __future__ import annotations

import fcntl
import json
import os
import shutil
import wave

import numpy as np

from . import s3file as s3
from .mdef import S3_SILENCE_CIPHONE, write_bin_mdef

# The CMU phone set, silence and the two noise phones, in the sorted
# order the published mdef lists them.
CI_PHONES = (
    "+NSN+", "+SPN+", "AA", "AE", "AH", "AO", "AW", "AY", "B", "CH", "D",
    "DH", "EH", "ER", "EY", "F", "G", "HH", "IH", "IY", "JH", "K", "L", "M",
    "N", "NG", "OW", "OY", "P", "R", "S", "SH", "SIL", "T", "TH", "UH", "UW",
    "V", "W", "Y", "Z", "ZH",
)
FILLER_PHONES = ("+NSN+", "+SPN+", "SIL")
NOISE_WORDS = (("<s>", "SIL"), ("</s>", "SIL"), ("<sil>", "SIL"),
               ("[NOISE]", "+NSN+"), ("[SPEECH]", "+SPN+"))

# Front-end row of BASELINE.md: 8 kHz-band mel filters, 100 frames/s,
# 25.625 ms window, 512-point FFT, 13 cepstra -> 1s_c_d_dd, svspec 3x13.
FEAT_PARAMS = {
    "samprate": 16000, "frate": 100, "wlen": 0.025625, "nfft": 512,
    "lowerf": 130, "upperf": 3700, "nfilt": 20, "ncep": 13,
    "transform": "dct", "lifter": 22, "feat": "1s_c_d_dd",
    "svspec": "0-12/13-25/26-38", "cmn": "current",
}

PRESETS = {
    # published en-us counts (BASELINE.md:13)
    "en-us": dict(n_phone=137_095, n_sen=5_126, n_sseq=28_458,
                  n_words=134_784, train_occ=24),
    "tiny": dict(n_phone=300, n_sen=360, n_sseq=159, n_words=300,
                 train_occ=12),
}
N_EMIT = 3
N_STREAM, N_DENSITY, VECLEN = 3, 128, 13
SAMPRATE = FEAT_PARAMS["samprate"]
FRAME = SAMPRATE // FEAT_PARAMS["frate"]          # samples per frame
N_UTTS = 8                                         # seeded WAVs written

_REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def default_dir(preset: str, seed: int) -> str:
    return os.path.join(_REPO_ROOT, ".seeded", f"{preset}-{seed}")


def write_seeded_model(preset: str = "en-us", seed: int = 0,
                       outdir: str | None = None) -> str:
    """Write (or reuse) the seeded model directory; returns its path.

    Concurrent callers (test workers) serialize on a lock file, and the
    directory appears atomically, so a reader never sees a partial one.
    """
    if preset not in PRESETS:
        raise ValueError(f"unknown preset {preset!r}; have {sorted(PRESETS)}")
    outdir = outdir or default_dir(preset, seed)
    if os.path.exists(os.path.join(outdir, "mdef")):
        return outdir
    parent = os.path.dirname(os.path.abspath(outdir))
    os.makedirs(parent, exist_ok=True)
    with open(os.path.join(parent, f".{os.path.basename(outdir)}.lock"),
              "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if not os.path.exists(os.path.join(outdir, "mdef")):
            tmp = outdir + ".partial"
            shutil.rmtree(tmp, ignore_errors=True)
            os.makedirs(tmp)
            _write(tmp, PRESETS[preset], np.random.default_rng(seed))
            os.rename(tmp, outdir)
    return outdir


# -- model structure --------------------------------------------------------

def _split(total: int, n: int) -> np.ndarray:
    """total split into n near-equal positive parts."""
    out = np.full(n, total // n, np.int64)
    out[: total % n] += 1
    return out


def _structure(p: dict, rng):
    """Triphones, senone sequences and senones of the PTM model.

    CI phone c owns senones 3c..3c+2.  Every CD senone belongs to one
    base phone, so (as in PTM) it scores with its base phone's
    codebook; each base phone's senone sequences draw one senone per
    state from that base's per-state pools."""
    n_ci = len(CI_PHONES)
    ci_id = {n: i for i, n in enumerate(CI_PHONES)}
    bases = [ci_id[n] for n in CI_PHONES if n not in FILLER_PHONES]
    sil = ci_id[S3_SILENCE_CIPHONE]
    ctx = np.array(bases + [sil], np.int64)      # fillers map to SIL
    n_cd = p["n_phone"] - n_ci
    n_ci_sen = n_ci * N_EMIT
    nb = len(bases)
    sen_per_base = _split(p["n_sen"] - n_ci_sen, nb)
    sseq_per_base = _split(p["n_sseq"] - n_ci, nb)
    phones_per_base = _split(n_cd, nb)

    sseq = [[3 * c, 3 * c + 1, 3 * c + 2] for c in range(n_ci)]
    cd = []                                       # (wpos, base, lc, rc, ssid)
    next_sen = n_ci_sen
    n_ctx = len(ctx)
    for k, b in enumerate(bases):
        pools = []
        for n in _split(int(sen_per_base[k]), N_EMIT):
            pools.append(np.arange(next_sen, next_sen + n))
            next_sen += n
        # the first max-pool-size sequences cycle through every pool
        # member, so every senone is used; the rest are distinct draws
        q = int(sseq_per_base[k])
        widest = max(len(x) for x in pools)
        if q < widest or q > np.prod([len(x) for x in pools]):
            raise ValueError("senone-sequence count does not fit the pools")
        seqs = [tuple(int(x[i % len(x)]) for x in pools)
                for i in range(widest)]
        seen = set(seqs)
        while len(seqs) < q:
            s = tuple(int(x[rng.integers(len(x))]) for x in pools)
            if s not in seen:
                seen.add(s)
                seqs.append(s)
        first = len(sseq)
        sseq.extend(list(s) for s in seqs)
        m = int(phones_per_base[k])
        if m < q:
            raise ValueError("fewer triphones than senone sequences")
        flat = rng.choice(4 * n_ctx * n_ctx, size=m, replace=False)
        wpos, rest = np.divmod(flat, n_ctx * n_ctx)
        lc, rc = np.divmod(rest, n_ctx)
        ss = np.concatenate([rng.permutation(q),
                             rng.integers(0, q, m - q)]) + first
        for w, l_, r_, s in zip(wpos, ctx[lc], ctx[rc], ss):
            cd.append((int(w), b, int(l_), int(r_), int(s)))
    cd.sort(key=lambda t: (t[1], t[2], t[3], t[0]))
    return dict(n_ci=n_ci, sil=sil, bases=bases, cd=cd,
                sseq=np.array(sseq, np.uint16), n_sen=p["n_sen"],
                n_ci_sen=n_ci_sen)


# -- synthetic phone sounds ---------------------------------------------------

def _phone_sounds(rng) -> dict:
    """Per-CI-phone synthesis parameters: formant frequencies [42, 3],
    their amplitudes [42, 3] and a white-noise level [42]."""
    n = len(CI_PHONES)
    freqs = np.sort(rng.uniform(200.0, 3500.0, (n, 3)), axis=1)
    amps = rng.uniform(1500.0, 6000.0, (n, 3))
    noise = rng.uniform(50.0, 1500.0, n)
    for i, name in enumerate(CI_PHONES):
        if name == "SIL":
            amps[i] = 0.0
            noise[i] = 30.0
        elif name == "+NSN+":
            amps[i] = 0.0
            noise[i] = 2500.0
    return dict(freqs=freqs, amps=amps, noise=noise)


def synthesize(sounds: dict, phones, durations, rng) -> np.ndarray:
    """int16 audio for a phone sequence with per-phone frame counts."""
    out = []
    ramp = np.minimum(1.0, np.arange(FRAME // 2) / (FRAME // 2))
    for ph, d in zip(phones, durations):
        n = int(d) * FRAME
        t = np.arange(n) / SAMPRATE
        f = sounds["freqs"][ph] * rng.uniform(0.97, 1.03, 3)
        x = rng.normal(0.0, sounds["noise"][ph], n)
        for j in range(3):
            x += sounds["amps"][ph, j] * np.sin(
                2 * np.pi * f[j] * t + rng.uniform(0, 2 * np.pi))
        env = np.ones(n)
        env[: len(ramp)] = 0.3 + 0.7 * ramp
        env[-len(ramp):] = np.minimum(env[-len(ramp):], 0.3 + 0.7 * ramp[::-1])
        out.append(x * env)
    return np.clip(np.concatenate(out), -32768, 32767).astype(np.int16)


def _train_gaussians(sounds: dict, occ: int, rng):
    """Fit each CI phone's codebook to front-end features of its sound.

    One seeded training utterance (every phone ``occ`` times, silence
    about as often as in ``Corpus`` utterances) goes through the
    package's own front end on the CPU device, batch CMN and 1s_c_d_dd;
    each Gaussian's mean is a feature frame of its phone and each
    variance that phone's per-dimension variance, jittered.  Also
    returns the utterance's mean cepstrum, the model's live-CMN
    starting point (``cmninit``)."""
    import jax

    from .config import Config
    from .fe.feat import feats_full_utt_np
    from .fe.frontend import Frontend

    n = len(CI_PHONES)
    sil = CI_PHONES.index(S3_SILENCE_CIPHONE)
    seq = np.concatenate([np.repeat(np.arange(n), occ),
                          np.full(occ * 6, sil)])
    seq = rng.permutation(seq)
    durs = rng.integers(6, 15, len(seq))
    audio = synthesize(sounds, seq, durs, rng)
    fe = Frontend.from_config(Config(FEAT_PARAMS))
    with jax.default_device(jax.devices("cpu")[0]):
        cep = fe.process_int16(audio)
    feats = feats_full_utt_np(cep, FEAT_PARAMS["cmn"])   # [T, 3, 13]
    T = len(feats)
    label = np.repeat(seq, durs)
    centre = np.minimum(np.arange(T) * FRAME + fe.frame_size // 2,
                        len(audio) - 1) // FRAME
    label = label[np.minimum(centre, len(label) - 1)]
    means = np.zeros((n, N_STREAM, N_DENSITY, VECLEN), np.float32)
    var = np.zeros_like(means)
    floor = 0.05 * feats.var(axis=0)                          # [3, 13]
    shape = (N_DENSITY, N_STREAM, VECLEN)
    for c in range(n):
        fr = feats[label == c]
        v = np.maximum(fr.var(axis=0), floor)                 # [3, 13]
        # Gaussians spread about the phone's frames like a trained
        # codebook's: distances to a frame stay distinct, so exact ties
        # in the top-N (which the C scorer and the device scorer break
        # differently) stay as rare as in a published model
        pick = fr[rng.integers(0, len(fr), N_DENSITY)] \
            + rng.normal(0.0, 1.0, shape) * np.sqrt(v)[None]
        means[c] = np.transpose(pick, (1, 0, 2))
        var[c] = v[:, None, :] * np.exp(
            rng.normal(0.0, 0.6, (N_STREAM, N_DENSITY, VECLEN)))
    return means, var, cep.mean(axis=0)


# -- dictionary ---------------------------------------------------------------

def _words(n_entries: int, bases: list, rng) -> list[tuple[str, list[int]]]:
    """n_entries dictionary lines: words of 2-12 non-filler phones
    (lengths weighted like an English lexicon), about 1 in 20 followed
    by an alternate pronunciation ``word(2)`` differing in one phone."""
    lens = np.arange(2, 13)
    w = np.exp(-0.5 * ((lens - 6.5) / 2.5) ** 2)
    w /= w.sum()
    names = {}
    out = []
    bases = np.asarray(bases)
    while len(out) < n_entries:
        pron = bases[rng.integers(0, len(bases), rng.choice(lens, p=w))]
        stem = "".join(CI_PHONES[p].lower() for p in pron[:4])
        k = names.get(stem, 0)
        names[stem] = k + 1
        word = stem if k == 0 else f"{stem}{k}"
        out.append((word, pron.tolist()))
        if len(out) < n_entries and rng.random() < 0.05:
            alt = pron.copy()
            alt[rng.integers(len(alt))] = bases[rng.integers(len(bases))]
            out.append((f"{word}(2)", alt.tolist()))
    return out


# -- writing ------------------------------------------------------------------

def _write(d: str, p: dict, rng) -> None:
    st = _structure(p, rng)
    n_ci = st["n_ci"]
    phones = [(c, -1, -1, -1, c) for c in range(n_ci)] + \
        [(b, l_, r_, w, s) for (w, b, l_, r_, s) in st["cd"]]
    write_bin_mdef(
        os.path.join(d, "mdef"), CI_PHONES,
        filler=[n in FILLER_PHONES for n in CI_PHONES],
        phones=phones, sseq=st["sseq"], n_ci_sen=st["n_ci_sen"],
        n_sen=st["n_sen"], n_tmat=n_ci, sil=st["sil"])

    # left-to-right tmats, no skips: self-loop 0.55-0.9 per state
    tp = np.zeros((n_ci, N_EMIT, N_EMIT + 1), np.float32)
    for i in range(N_EMIT):
        stay = rng.uniform(0.55, 0.9, n_ci)
        tp[:, i, i] = stay
        tp[:, i, i + 1] = 1.0 - stay
    s3.write_tmat_params(os.path.join(d, "transition_matrices"), tp)

    sounds = _phone_sounds(rng)
    means, var, cep_mean = _train_gaussians(sounds, p["train_occ"], rng)
    veclen = [VECLEN] * N_STREAM
    s3.write_gauden_params(os.path.join(d, "means"), means, veclen)
    s3.write_gauden_params(os.path.join(d, "variances"), var, veclen)

    # 4-bit clustered mixture weights: 16 negated-log levels, senones
    # favouring a few densities of their codebook
    mixw_cb = np.round(np.linspace(12, 159, 16)).astype(np.uint8)
    level_p = np.linspace(1.0, 3.0, 16)
    cw = rng.choice(16, size=(N_STREAM, N_DENSITY, p["n_sen"]),
                    p=level_p / level_p.sum())
    s3.write_sendump_4b(os.path.join(d, "sendump"), cw.astype(np.uint8),
                        mixw_cb, p["n_sen"])

    with open(os.path.join(d, "feat_params.json"), "w") as fh:
        json.dump({**FEAT_PARAMS, "cmninit": ",".join(
            f"{x:.2f}" for x in cep_mean)}, fh, indent=1)
    words = _words(p["n_words"], st["bases"], rng)
    with open(os.path.join(d, "dict.txt"), "w") as fh:
        fh.writelines(f"{w} {' '.join(CI_PHONES[x] for x in pr)}\n"
                      for w, pr in words)
    with open(os.path.join(d, "noisedict.txt"), "w") as fh:
        fh.writelines(f"{w} {ph}\n" for w, ph in NOISE_WORDS)
    np.savez(os.path.join(d, "sounds.npz"), **sounds)

    corpus = Corpus(d)
    os.makedirs(os.path.join(d, "audio"))
    lines = []
    for i in range(N_UTTS):
        audio, text = corpus.pair(rng, seconds=rng.uniform(2.0, 6.0))
        name = f"utt{i:02d}.wav"
        with wave.open(os.path.join(d, "audio", name), "wb") as wf:
            wf.setnchannels(1)
            wf.setsampwidth(2)
            wf.setframerate(SAMPRATE)
            wf.writeframes(audio.tobytes())
        lines.append(f"{name} {text}\n")
    with open(os.path.join(d, "audio", "transcripts.txt"), "w") as fh:
        fh.writelines(lines)


# -- seeded utterances -------------------------------------------------------

class Corpus:
    """Seeded utterances for a seeded model directory: transcripts drawn
    from its dictionary, audio synthesized from the pronunciations with
    the model's phone sounds."""

    def __init__(self, model_dir: str):
        with np.load(os.path.join(model_dir, "sounds.npz")) as z:
            self.sounds = {k: z[k] for k in z.files}
        ci = {n: i for i, n in enumerate(CI_PHONES)}
        self.sil = ci[S3_SILENCE_CIPHONE]
        self.words: list[str] = []
        self.prons: list[list[int]] = []
        with open(os.path.join(model_dir, "dict.txt")) as fh:
            for line in fh:
                w, *ph = line.split()
                if not w.endswith(")"):
                    self.words.append(w)
                    self.prons.append([ci[x] for x in ph])
        self._index = {w: i for i, w in enumerate(self.words)}

    def transcript(self, rng, n_words: int) -> str:
        return " ".join(self.words[i] for i in
                        rng.integers(0, len(self.words), n_words))

    def audio(self, text: str, rng, seconds: float | None = None
              ) -> np.ndarray:
        """Leading and trailing silence, 6-14 frames per phone, and a
        short pause after about one word in five.  With ``seconds``, the
        edge silences grow until the audio lasts that long."""
        phones = [self.sil]
        durs = [int(rng.integers(20, 41))]
        for w in text.split():
            pr = self.prons[self._index[w]]
            phones += pr
            durs += rng.integers(6, 15, len(pr)).tolist()
            if rng.random() < 0.2:
                phones.append(self.sil)
                durs.append(int(rng.integers(10, 26)))
        phones.append(self.sil)
        durs.append(int(rng.integers(20, 41)))
        if seconds is not None:
            extra = max(0, int(seconds * FEAT_PARAMS["frate"]) - sum(durs))
            lead = int(rng.integers(0, extra + 1))
            durs[0] += lead
            durs[-1] += extra - lead
        return synthesize(self.sounds, phones, durs, rng)

    def pair(self, rng, seconds: float) -> tuple[np.ndarray, str]:
        """An (audio, transcript) pair of about ``seconds`` seconds."""
        words: list[str] = []
        frames = 60                               # edge silences
        while frames < seconds * FEAT_PARAMS["frate"] or not words:
            i = int(rng.integers(0, len(self.words)))
            words.append(self.words[i])
            frames += 10 * len(self.prons[i]) + 3
        text = " ".join(words)
        return self.audio(text, rng), text
