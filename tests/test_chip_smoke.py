"""chip_smoke.py's phases at tiny sizes on the CPU backend.

On the card the script drives every device path at full size; here each
phase function runs on a few seconds of audio, so its control flow, its
engine knobs, the device-program witness and the oracle comparisons are
exercised on every test run. ``main()`` itself refuses any backend but the
GPU, which is checked too. The four-card paths run on four of the
conftest's virtual CPU devices.
"""

import os
import shutil
import subprocess
import sys

import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO not in sys.path:
    sys.path.insert(0, REPO)

import chip_smoke as cs  # noqa: E402


@pytest.fixture
def work(tmp_path):
    return str(tmp_path)


@pytest.fixture
def rng():
    return np.random.default_rng(0)


def test_main_refuses_cpu_backend(capsys):
    assert cs.main([]) != 0
    out = capsys.readouterr().out
    assert '"ok"' not in out and "phase" not in out


def test_only_takes_mesh_phases():
    with pytest.raises(SystemExit) as e:
        cs.main(["--four", "--only", "files,corpus"])
    assert e.value.code != 0


def test_script_alone_fails(tmp_path):
    """Copied into a directory with nothing else of the repo, the script
    exits non-zero and prints no result line."""
    shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    r = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path,
                       env=env, capture_output=True, text=True, timeout=300)
    assert r.returncode != 0
    assert '"ok"' not in r.stdout


def test_lsb_contract():
    a = np.zeros(10000, np.int16)
    b = a.copy()
    b[:5] = 1
    assert "max |diff| 1 LSB" in cs._lsb_compare([(b, a)], "x")
    b[0] = 2
    with pytest.raises(cs.PhaseError):
        cs._lsb_compare([(b, a)], "x")
    b[:] = 1                                   # 1 LSB, but on every sample
    with pytest.raises(cs.PhaseError):
        cs._lsb_compare([(b, a)], "x")


def test_track_lengths(rng):
    x = cs.track_lengths(rng, 64, 10800.0, 30.0, 420.0)
    assert x.min() >= 30.0 and x.max() <= 420.0
    assert abs(x.sum() - 10800.0) < 0.05 * 10800.0


def test_witness_requires_a_device_run():
    with pytest.raises(cs.PhaseError):
        cs._devices_of([], "prog")


def test_phase_corpus_decode(work, rng, capsys):
    (paths, _), pcm = cs.phase_corpus_decode(work, rng, n_tracks=3,
                                             total_s=8.0, lo=2.0, hi=4.0)
    assert len(pcm) == len(paths) == 3
    assert all(p.dtype == np.int16 for p in pcm)
    assert "phase 1 corpus decode" in capsys.readouterr().out


def test_phase_facade_and_device_huffman(work, rng, capsys):
    hidden, wav = cs.phase_facade_decode(work, rng, seconds=3.0,
                                         msg_chars=4)
    cs.phase_device_huffman(work, hidden, wav)
    out = capsys.readouterr().out
    assert "phase 2" in out and "phase 3" in out


def test_phase_encode(work, rng, capsys):
    cs.phase_encode(work, rng, seconds=3.0)
    assert "bytes identical to host engine" in capsys.readouterr().out


def test_phase_hide_capacity(work, rng, capsys):
    cs.phase_hide_capacity(work, rng, seconds=3.0)
    assert "reveal whole" in capsys.readouterr().out


def test_phase_batch_encode(work, rng, capsys):
    cs.phase_batch_encode(work, rng, n_jobs=2, seconds=2.0)
    assert "byte-identical" in capsys.readouterr().out


def test_four_card_files_mesh(work, rng, capsys):
    from mp3stego_tpu.parallel import make_mesh
    corpus, one = cs.phase_corpus_decode(work, rng, n_tracks=3, total_s=6.0,
                                         lo=1.5, hi=3.0)
    cs.phase_corpus_decode(work, rng, mesh=make_mesh(files=4), corpus=corpus,
                           want=(one, "one-card PCM"))
    out = capsys.readouterr().out
    assert "'files': 4" in out and "vs one-card PCM" in out


def test_four_card_frames_mesh(work, rng, capsys):
    from mp3stego_tpu.parallel import make_mesh
    cs.phase_frames_mesh(work, rng, make_mesh(files=1, frames=4),
                         seconds=3.0)
    assert "frames-sharded decode" in capsys.readouterr().out


def test_four_card_batch_encode(work, rng, capsys):
    from mp3stego_tpu.parallel import make_mesh
    wavs = cs.phase_batch_encode(work, rng, n_jobs=2, seconds=2.0)
    for w in wavs:
        os.replace(w[:-4] + "_dev.mp3", w[:-4] + "_one.mp3")
    cs.phase_batch_encode(work, rng, mesh=make_mesh(files=4), wavs=wavs,
                          want=([w[:-4] + "_one.mp3" for w in wavs],
                                "the one-card encodes"))
    out = capsys.readouterr().out
    assert "'files': 4" in out and "the one-card encodes" in out


@pytest.mark.gpu
def test_phases_on_gpu(gpu_device, work, rng):
    """The single-card phases at small sizes on a real card, trace
    included (run with ``-m gpu``)."""
    hidden, wav = cs.phase_facade_decode(work, rng, seconds=20.0,
                                         msg_chars=20)
    cs.phase_device_huffman(work, hidden, wav)
    cs.phase_encode(work, rng, seconds=20.0)
    cs.phase_trace(work, hidden, os.path.join(work, "enc.wav"))
