"""The port's live app and its host pieces (``streaming/{sources,audio_io,
core,display,audio_config,app}.py``) on the CPU, against the JAX
package's, on the cases of tests/test_streaming.py:24,34,41,126,166,184,
193,321,335 and tests/test_aux.py:111, with a synthetic pair the tests
render (``eval/synthetic``'s "steady" case).

Tolerance: sources, sinks, generators, widgets and configuration equal
exactly; the app's field log equals the path of a follower built
directly, point for point.  The port's device frontend and JAX's differ by
up to 2.15e-6 (docs/PARITY.md), which moves near-tie points, so the app
against JAX's app on the same wavs compares ``PathScorer`` buckets,
within 1 point."""

import os
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from real_time_audio_sync_tpu.eval.scorer import PathScorer as JaxScorer  # noqa: E402
from real_time_audio_sync_tpu.streaming import app as japp  # noqa: E402
from real_time_audio_sync_tpu.streaming import audio_config as jconfig  # noqa: E402
from real_time_audio_sync_tpu.streaming import audio_io as jio  # noqa: E402
from real_time_audio_sync_tpu.streaming import display as jdisplay  # noqa: E402
from real_time_audio_sync_tpu.streaming import sources as jsources  # noqa: E402
from real_time_audio_sync_tpu.streaming.runtime import AudioMeter as JaxMeter  # noqa: E402
from real_time_audio_sync_tpu_torch import streaming as tstreaming  # noqa: E402
from real_time_audio_sync_tpu_torch.eval import synthetic as tsyn  # noqa: E402
from real_time_audio_sync_tpu_torch.eval.logs import parse_field_log  # noqa: E402
from real_time_audio_sync_tpu_torch.eval.scorer import PathScorer  # noqa: E402
from real_time_audio_sync_tpu_torch.streaming import app as tapp  # noqa: E402
from real_time_audio_sync_tpu_torch.streaming import audio_config as tconfig  # noqa: E402
from real_time_audio_sync_tpu_torch.streaming import audio_io as tio  # noqa: E402
from real_time_audio_sync_tpu_torch.streaming import core as tcore  # noqa: E402
from real_time_audio_sync_tpu_torch.streaming import display as tdisplay  # noqa: E402
from real_time_audio_sync_tpu_torch.streaming import sources as tsources  # noqa: E402
from real_time_audio_sync_tpu_torch.streaming.runtime import AudioMeter, ScoreFollower, WTWFollower  # noqa: E402
from real_time_audio_sync_tpu_torch.utils.wavio import load_wav  # noqa: E402


@pytest.fixture(scope="module")
def pair(tmp_path_factory):
    """A short rendered pair (14.4 s reference, 12.9 s live) with beat CSVs."""
    root = tmp_path_factory.mktemp("songs")
    tsyn.build_corpus(str(root), ["steady"])
    return str(root / "steady" / "steady_00.wav"), str(root / "steady" / "steady_01.wav")


def _chunks_equal(got, want):
    got, want = list(got), list(want)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)


# -- sources (tests/test_streaming.py:24,34) ------------------------------------


def test_sources_equal_jax(pair):
    _, live = pair
    samples, _ = load_wav(live)
    _chunks_equal(tsources.WavChunkSource(live, 64), jsources.WavChunkSource(live, 64))
    _chunks_equal(tsources.SimulatedMic(live, buffer_size=512), jsources.SimulatedMic(live, buffer_size=512))
    _chunks_equal(tsources.SimulatedMic(samples=samples[:5000], buffer_size=700),
                  jsources.SimulatedMic(samples=samples[:5000], buffer_size=700))
    np.testing.assert_array_equal(np.concatenate(list(tsources.SimulatedMic(live))), samples)
    with pytest.raises(ValueError, match="need a wav path or a samples array"):
        tsources.SimulatedMic()


def test_threaded_source_equals_the_source(pair):
    _, live = pair
    samples, _ = load_wav(live)
    got = np.concatenate(list(tsources.ThreadedSource(tsources.SimulatedMic(live, buffer_size=600))))
    np.testing.assert_array_equal(got, samples)


def test_without_an_audio_backend_mic_and_device_sink_raise(monkeypatch):
    """No pyaudio and no sounddevice (as on a GPU server): both packages'
    microphone and output device raise the same error."""
    monkeypatch.setitem(sys.modules, "pyaudio", None)
    monkeypatch.setitem(sys.modules, "sounddevice", None)
    for mic in (tsources.MicSource, jsources.MicSource):
        with pytest.raises(RuntimeError, match="no microphone backend available"):
            mic()
    for sink in (tio.DeviceSink, jio.DeviceSink):
        with pytest.raises(RuntimeError, match="no audio output backend available"):
            sink()


# -- meter and writer (tests/test_streaming.py:41) -------------------------------


def test_audio_meter_equals_jax():
    rng = np.random.default_rng(4)
    meter, jmeter = AudioMeter(), JaxMeter()
    for buf in (np.ones(512, np.float32) * 0.5, rng.standard_normal(300).astype(np.float32), np.zeros(64)):
        assert meter.update(buf) == jmeter.update(buf)


# -- audio output (tests/test_streaming.py:126,166) -----------------------------


def _pump(io, ref, live):
    got_in, got_listen = [], []
    sink = io.BufferSink(frames_per_poll=512)
    duplex = io.DuplexAudio(num_channels=1, input_func=lambda buf, ch: got_in.append(buf),
                            listen_func=lambda buf, ch: got_listen.append(buf),
                            input_source=tsources.SimulatedMic(live, buffer_size=512), sink=sink)
    duplex.set_generator(io.WavPlayback(ref))
    polls = 0
    while duplex.generator is not None:
        duplex.on_update()
        polls += 1
        assert polls < 10_000
    assert duplex.get_cpu_load() > 0.0
    return sink.samples(), got_in, got_listen


def test_duplex_pump_equals_jax(pair):
    """The reference Audio's duplex contract (ims/audio.py:64-103): per
    polled frame, input drains to input_func and the generator supplies
    exactly get_write_available() frames; the same streams as JAX's."""
    ref, live = pair
    out, got_in, got_listen = _pump(tio, ref, live)
    jout, jin, jlisten = _pump(jio, ref, live)
    np.testing.assert_array_equal(out, jout)
    _chunks_equal(got_in, jin)
    _chunks_equal(got_listen, jlisten)
    src, _ = load_wav(ref)
    np.testing.assert_array_equal(out[: len(src)], src)
    np.testing.assert_array_equal(out[len(src):], 0)
    np.testing.assert_array_equal(np.concatenate(got_listen), out)


def test_wav_file_sink_writes_jax_bytes(tmp_path):
    data = np.sin(np.arange(3000) / 7.0).astype(np.float32) * 0.5
    for io, name in ((tio, "t.wav"), (jio, "j.wav")):
        sink = io.WavFileSink(str(tmp_path / name), frames_per_poll=256)
        sink.write(data[:1000])
        sink.write(data[1000:])
        assert sink.get_write_available() == 256
        sink.close()
    assert (tmp_path / "t.wav").read_bytes() == (tmp_path / "j.wav").read_bytes()


@pytest.mark.parametrize("channels", [1, 2])
def test_click_track_equals_jax(channels):
    beats = [0.1, 0.5, 1.0]
    gens = tio.ClickTrack(beats, click_sec=0.02), jio.ClickTrack(beats, click_sec=0.02)
    chunks, more = [], True
    while more:
        (data, more), (jdata, jmore) = (g.generate(512, channels) for g in gens)
        np.testing.assert_array_equal(data, jdata)
        assert more == jmore
        chunks.append(data)
    out = np.concatenate(chunks)[::channels]
    for b in beats:  # energy exactly around each beat, silence away from them
        k = int(b * 22050)
        assert np.abs(out[k : k + 440]).max() > 0.1
    assert np.abs(out[int(0.3 * 22050) : int(0.4 * 22050)]).max() == 0.0


# -- display widgets and the app scaffold (tests/test_streaming.py:184,193,321,335)


def test_display_widgets_equal_jax():
    def render_all(d):
        m = d.MeterDisplay((-96, 0), width=10)
        m.set(-48)
        g = d.GraphDisplay(num_pts=5, in_range=(0, 8))
        for v in range(8):
            g.add_point(v)
        kf = d.KFAnim((0, 0.0), (2, 10.0), (3, 4.0))
        e = d.CEllipse(cpos=(50, 40), csize=(20, 10))
        e.csize = (40, 20)
        cur = d.Cursor3D(area_size=(200, 100), area_pos=(10, 20), size_range=(10, 50))
        cur.set_pos(np.array([0.25, 0.5, 1.0]))
        label = d.topleft_label(width=24)
        label.text = "beat 12.50 [110-1]"
        group = d.AnimGroup()
        group.add(type("Once", (), {"on_update": lambda self, dt: False})())
        group.on_update()
        return (m.render(), g.render(), kf.eval(1), kf.eval(2.5), kf.is_active(1), kf.is_active(3), e.pos, e.cpos,
                cur.get_screen_xy(), cur.cursor.csize, cur.render(cols=21, rows=7), label.render(), group.size())

    got = render_all(tdisplay)
    assert got == render_all(jdisplay)
    assert got[0].count("█") == 5 and got[2] == 5.0 and got[7] == (50, 40) and "●" in got[10]


def test_app_loop_terminate_funcs_run_on_crash():
    ran = []

    class Crashy(tcore.AppLoop):
        def main(self):
            raise RuntimeError("boom")

    tcore.register_terminate_func(lambda: ran.append("cleanup"))
    tcore.run(Crashy())  # must not raise; cleanup must run (ims/core.py:95-102)
    assert ran == ["cleanup"]
    tcore.run(Crashy())  # the funcs ran once and were cleared
    assert ran == ["cleanup"]

    keys = []
    loop = type("Keys", (tcore.AppLoop,), {"on_key_down": lambda self, k, m=None: keys.append(k)})()
    loop.pump("ab")
    assert keys == ["a", "b"] and tcore.lookup(2, [1, 2], "xy") == "y" and tcore.lookup(3, [1, 2], "xy") is None


def test_audio_config_round_trip_equals_jax(tmp_path):
    """tests/test_aux.py:111 in the port, and the file each package writes
    is the other's."""
    assert tconfig.DEFAULTS == jconfig.DEFAULTS and tconfig.CONFIG_FILE == jconfig.CONFIG_FILE
    path = str(tmp_path / "audio_config.cfg")
    cfg = tconfig.load_audio_config(path)
    assert cfg == tconfig.DEFAULTS  # a missing file gives the defaults (ims/audio.py:155-166)
    cfg["buffersize"] = 1024
    tconfig.save_audio_config(cfg, path)
    cfg2 = tconfig.load_audio_config(path)
    assert cfg2["buffersize"] == 1024 and cfg2["outputdevice"] is None  # 'None' round-trips
    assert cfg2 == jconfig.load_audio_config(path)
    cfg2["inputdevice"] = 99  # an invalid index resets against the (backend-less) device list
    tconfig.save_audio_config(cfg2, path)
    jconfig.save_audio_config(cfg2, str(tmp_path / "j.cfg"))
    assert (tmp_path / "audio_config.cfg").read_bytes() == (tmp_path / "j.cfg").read_bytes()
    assert tconfig.load_audio_config(path)["inputdevice"] is None
    assert tconfig.get_audio_devices() == jconfig.get_audio_devices()


def test_streaming_package_exports_the_jax_names():
    import real_time_audio_sync_tpu.streaming as jstreaming

    public = {n for n in dir(jstreaming) if not n.startswith("_") and n[0].isupper() or n in (
        "combine_buffers", "write_wave_file")}
    assert public - set(dir(tstreaming)) == set()


# -- the app (streaming/app.py) ----------------------------------------------------


def _direct(engine, ref, live):
    """The follower the app builds, fed the app's 512-sample buffers."""
    f = WTWFollower(ref, live, device="cpu") if engine == "wtw" else ScoreFollower(ref, engine, device="cpu")
    f.start()
    for buf in tsources.SimulatedMic(live):
        f.receive_audio(buf)
        if f.stopped:
            break
    f.stop()
    return [tuple(int(v) for v in p) for p in f.path]


@pytest.mark.parametrize("engine", ["otw", "wtw"])
def test_main_writes_the_field_log_of_a_direct_follower(engine, pair, tmp_path, capsys):
    """``main([... "--device", "cpu"])``: its field log parses to the path
    of a follower built directly, exactly, and scores within 1 point of
    the JAX app's on the same wavs."""
    ref, live = pair
    log_dir = tmp_path / "port"
    assert tapp.main(["--ref", ref, "--live", live, "--engine", engine, "--log-dir", str(log_dir),
                      "--device", "cpu"]) == 0
    assert "path log written to" in capsys.readouterr().out
    (log,) = os.listdir(log_dir)
    path = parse_field_log(str(log_dir / log)).path
    assert len(path) > 20
    assert path == _direct(engine, ref, live)

    jax_follower = japp.follow_live(ref, live, engine=engine, log_dir=None, quiet=True)
    got = PathScorer.for_pair(ref, live).score(path)
    want = JaxScorer.for_pair(ref, live).score([tuple(int(v) for v in p) for p in jax_follower.path])
    assert got.count == pytest.approx(want.count, abs=2)
    for t in got.pct_off_beats:
        assert abs(got.pct_off_beats[t] - want.pct_off_beats[t]) <= 1.0, t


def test_follow_live_defaults_and_blocks(pair, tmp_path):
    """``follow_live`` runs on the card unless asked, writes no log without
    a log_dir, and ``use_blocks`` gives the per-hop path."""
    import inspect

    assert inspect.signature(tapp.follow_live).parameters["device"].default == "cuda"
    ref, live = pair
    f = tapp.follow_live(ref, live, log_dir=None, use_blocks=True, quiet=True, device="cpu")
    assert f.use_blocks and f._log_path is None
    assert [tuple(int(v) for v in p) for p in f.path] == _direct("otw", ref, live)
