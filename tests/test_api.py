"""API-surface tests: endpointer, VAD, native IO, config round trip."""

import numpy as np
import pytest

from tests.conftest import DATADIR

from soundswallower_tpu.config import Config
from soundswallower_tpu.endpointer import Endpointer
from soundswallower_tpu.vad import Vad
from soundswallower_tpu.fe.cmn_live import CmnLive, CMN_WIN
from soundswallower_tpu.utils.native_io import read_audio, pack_batch


def test_config_roundtrip():
    c = Config(hmm="/tmp/x", beam=1e-40)
    js = c.serialize_json()
    c2 = Config()
    c2.parse_json(js)
    assert c2["beam"] == 1e-40
    assert c2["hmm"] == "/tmp/x"
    # dash-prefixed keys accepted
    assert c2["-beam"] == 1e-40
    with pytest.raises(KeyError):
        c2["nonexistent_param"]


def test_config_defaults_match_reference():
    c = Config()
    assert c["beam"] == 1e-48
    assert c["wbeam"] == 7e-29
    assert c["maxhmmpf"] == 30000
    assert c["lw"] == 6.5
    assert c["wip"] == 0.65
    assert c["silprob"] == 0.005
    assert c["logbase"] == 1.0001
    assert c["samprate"] == 16000
    assert c["wlen"] == 0.025625
    assert c["cmninit"] == "40,3,-1"


def test_vad_frame_sizing():
    v = Vad(sample_rate=16000, frame_length=0.03)
    assert v.frame_size == 480
    with pytest.raises(ValueError):
        Vad(sample_rate=16000, frame_length=0.0301)


def test_endpointer_segments_speech(reference):
    """The endpointer must detect the single speech region in goforward."""
    ep = Endpointer(sample_rate=16000)
    raw = np.fromfile(f"{DATADIR}/goforward.raw", dtype=np.int16)
    n = ep.frame_size
    speech = []
    for i in range(0, len(raw) - n + 1, n):
        out = ep.process(raw[i:i + n])
        if out is not None:
            speech.append(out)
    tail = ep.end_stream(raw[len(raw) - len(raw) % n:])
    if tail is not None:
        speech.append(tail)
    assert speech, "No speech detected in goforward"
    total = sum(len(s) for s in speech)
    # the utterance is ~2.0s of speech inside 2.78s of audio
    assert total > 16000  # at least a second


def test_cmn_live_window_decay():
    c = CmnLive(13)
    frames = np.ones((900, 13), np.float32) * 10
    c.process(frames)
    assert c.nframe == CMN_WIN  # decayed past the high-water mark
    c.update()
    assert abs(float(c.mean[0]) - 10.0) < 0.5


def test_native_io_wav_vs_raw(reference):
    s, r = read_audio(f"{DATADIR}/goforward.wav")
    s2, r2 = read_audio(f"{DATADIR}/goforward.raw")
    assert r == 16000 and r2 is None
    assert (s == s2).all()
    b = pack_batch([s, s2[:100]])
    assert b.shape == (2, len(s))
    assert b[1, 99] == float(s2[99]) and b[1, 100] == 0.0


def test_decoder_timing_and_logfile(tmp_path, reference):
    """utt_time/all_time perf counters (decoder.c:1252-1274) and
    set_logfile routing (decoder.c:201-228)."""
    import logging

    from soundswallower_tpu.decoder import Decoder

    d = Decoder(hmm="/root/reference/model/en-us", loglevel="INFO")
    logf = str(tmp_path / "decode.log")
    d.set_logfile(logf)
    d.set_align_text("go forward")
    raw = np.fromfile(f"{DATADIR}/goforward.raw", np.int16)[:8000]
    d.start_utt()
    d.process_raw(raw)
    d.end_utt()
    speech, cpu, wall = d.utt_time()
    assert abs(speech - 0.5) < 0.02     # 8000 samples @16k = 0.5s
    assert cpu > 0 and wall > 0
    a_speech, a_cpu, a_wall = d.all_time()
    assert a_speech == speech and a_wall >= wall
    d.set_logfile(None)
    log = open(logf).read()
    assert "xRT" in log and "HMMs" in log


def test_defective_inputs_fail_cleanly(reference):
    """The reference's failure-path fixtures (tests/data/defective.*,
    py/test/test_decoder.py test_decode_fail): bad inputs raise clean
    Python errors — never crash, never silently succeed."""
    import pytest

    from soundswallower_tpu.aligner import TpuAligner
    from soundswallower_tpu.decoder import Decoder

    # grammar with a word missing from the dictionary
    al = TpuAligner(hmm="/root/reference/model/en-us")
    with pytest.raises((KeyError, ValueError, RuntimeError)):
        al.set_grammar(
            jsgf_file="/root/reference/tests/data/defective.gram")
    with pytest.raises((KeyError, ValueError, RuntimeError)):
        Decoder(hmm="/root/reference/model/en-us",
                jsgf="/root/reference/tests/data/defective.gram")

    # defective dictionary: lines whose phones are missing from the
    # model are SKIPPED with an error log, not fatal (dict.c:214).
    # defective.dic uses lowercase phones, which the default
    # case-sensitive lookup rejects for EVERY word — loading succeeds
    # with none of them, exactly like the C
    al2 = TpuAligner(hmm="/root/reference/model/en-us",
                     dict="/root/reference/tests/data/defective.dic")
    for w in ("go", "forward", "ten", "degrees", "years"):
        assert al2.dict.wordid(w) < 0
    with pytest.raises((KeyError, RuntimeError)):
        al2.align(np.zeros(8000, np.int16), "go forward")

    # FSG whose dictionary lacks the words at a wrong sample rate
    # (the reference's test_decode_fail shape)
    with pytest.raises((KeyError, ValueError, RuntimeError)):
        Decoder(hmm="/root/reference/model/en-us",
                fsg="/root/reference/tests/data/goforward.fsg",
                dict="/root/reference/tests/data/turtle.dic",
                samprate=4000)


def test_float32_audio_ingest_matches_int16(reference):
    """decoder_process_float32 semantics (fe_process_float32 scaling by
    32768, dither off by default): float32 audio at exactly
    int16/32768 must yield the identical alignment."""
    from soundswallower_tpu.decoder import Decoder

    i16 = np.fromfile("/root/reference/tests/data/goforward_fr.raw",
                      np.int16)
    f32 = (i16.astype(np.float32) / np.float32(32768.0))

    def run(audio):
        d = Decoder(hmm="/root/reference/model/fr-fr",
                    dict="/root/reference/model/fr-fr/dict.txt")
        d.set_align_text("avance de dix mètres")
        d.start_utt()
        d.process_raw(audio)
        d.end_utt()
        return [(s["word"], s["sf"], s["ef"]) for s in d.seg_iter()]

    assert run(f32) == run(i16)
