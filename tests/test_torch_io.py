"""The port's input layer against the JAX package's, on the same bytes.

Each test of tests/test_io.py and the decode-pool tests of
tests/test_parallel.py, mirrored: the parsers' headers and packets, the
native shim's decoded planes bit for bit (paths, AVIO streams, stdin, the MKV
cross-check, a mid-stream resolution change), images, OpenCV frames,
ChunkedVideoSource's order and seeks, and the CLIs on compressed and image
pairs.  The port builds its own shim into turbo_metrics_tpu_torch/_build/;
the JAX package builds its own in native/.  Clips are written with
cv2.VideoWriter at 64x48 and skip where tests/test_io.py skips (no cv2, no
encoder).  Scores are held to tests/test_torch_slice.py's tolerances.
"""

import contextlib
import io
import json
import logging
import struct
import subprocess
import sys
from dataclasses import asdict
from pathlib import Path

import numpy as np
import pytest
import torch

from tests import torch_io_clips
from tests.test_io import _SPS_1080P, _ebml, _write_y4m

from turbo_metrics_tpu import cli as jax_cli
from turbo_metrics_tpu.io import h262 as jax_h262
from turbo_metrics_tpu.io import h264 as jax_h264
from turbo_metrics_tpu.io import av1 as jax_av1
from turbo_metrics_tpu.io import ivf as jax_ivf
from turbo_metrics_tpu.io import mkv as jax_mkv
from turbo_metrics_tpu.io import native as jax_native
from turbo_metrics_tpu.io import probe as jax_probe
from turbo_metrics_tpu.io.frame_source import ResolutionChanged as JaxResolutionChanged
from turbo_metrics_tpu.io.y4m import Y4MFrameSource as JaxY4M
from turbo_metrics_tpu.utils.stats import Stats as JaxStats

from turbo_metrics_tpu_torch import cli as port_cli
from turbo_metrics_tpu_torch.io import av1, h262, h264, ivf, mkv, native, opencv_source, probe
from turbo_metrics_tpu_torch.io.frame_source import ColorOverrideSource, ResolutionChanged
from turbo_metrics_tpu_torch.io.image import ImageFrameSource
from turbo_metrics_tpu_torch.io.y4m import Y4MFrameSource
from turbo_metrics_tpu_torch.parallel.decode_pool import ChunkedVideoSource
from turbo_metrics_tpu_torch.utils.stats import Stats

# One intra-op thread per xdist worker (tests/test_torch_slice.py).
torch.set_num_threads(1)

REPO = Path(__file__).resolve().parents[1]
W, H = 64, 48
# PSNR and SSIM as tests/test_torch_slice.py holds them.  SSIMULACRA2 at the
# repository's kernel-vs-plain bar, 0.01: on these decoded frames (smooth,
# low noise) the JAX package's f32 jnp chain is up to 0.0067 from an f64
# evaluation of the same chain at 64x48 and 0.0045 at 240x136, the port's
# CLI 0.0017 and 0.0003 (test_cli_compressed_pair_matches_y4m_and_jax checks
# the port's side).
ATOL = {"ssimulacra2": 1e-2, "psnr": 1e-4, "ssim": 1e-5}


def _frames_of(src) -> list:
    out = []
    while (f := src.get_frame()) is not None:
        out.append(f)
    return out


def _assert_same_frames(got, want):
    """RawFrames equal field for field, planes bit for bit."""
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert (g.kind, g.depth, g.full_range, g.chroma) == (w.kind, w.depth, w.full_range, w.chroma)
        for field in ("y", "uv", "rgb"):
            a, b = getattr(g, field), getattr(w, field)
            assert (a is None) == (b is None), field
            if a is not None:
                assert a.dtype == b.dtype and np.array_equal(a, b), field


def _cc(pair):
    cc, crange = pair
    return cc.cp.name, cc.mc.name, cc.tc.name, crange


def _write_clip(path, fourcc, frames, fps=25):
    cv2 = pytest.importorskip("cv2")
    h, w = frames[0].shape[:2]
    vw = cv2.VideoWriter(str(path), cv2.VideoWriter_fourcc(*fourcc), fps, (w, h))
    if not vw.isOpened():
        pytest.skip(f"{fourcc} encoder unavailable")
    for f in frames:
        vw.write(f)
    vw.release()
    return str(path)


@pytest.fixture(scope="module")
def vp9_mkv(tmp_path_factory):
    """tests/test_io.py's clip: five 64x48 VP9 frames in MKV."""
    frames = []
    for i in range(5):
        img = np.zeros((H, W, 3), np.uint8)
        img[:, :, 0] = i * 40
        img[: H // 2, :, 1] = 200
        img[:, : W // 2, 2] = 100
        frames.append(img)
    return _write_clip(tmp_path_factory.mktemp("vid") / "test.mkv", "VP90", frames)


@pytest.fixture(scope="module")
def reschange_ts(tmp_path_factory):
    """tests/test_io.py's concatenated MPEG-TS: 64x48 then 128x96."""
    d = tmp_path_factory.mktemp("resch")
    a = _write_clip(d / "a.ts", "MPG2", [np.full((48, 64, 3), 40 + i * 25, np.uint8) for i in range(4)])
    b = _write_clip(d / "b.ts", "MPG2", [np.full((96, 128, 3), 40 + i * 25, np.uint8) for i in range(4)])
    out = d / "cat.ts"
    out.write_bytes(Path(a).read_bytes() + Path(b).read_bytes())
    return str(out)


@pytest.fixture(scope="module")
def clip_pair(tmp_path_factory):
    """The generator's source at 64x48, 5 frames: a VP9 MKV reference and an
    MPEG-2 TS distorted stream, and Y4M files of their decoded frames."""
    d = tmp_path_factory.mktemp("pair")
    frames = torch_io_clips.source_frames(W, H, 5)
    ref = _write_clip(d / "ref.mkv", "VP90", frames)
    dis = _write_clip(d / "dis.ts", "MPG2", frames)
    y4m = []
    for path in (ref, dis):
        decoded = _frames_of(jax_native.NativeVideoSource(path))
        out = d / (Path(path).stem + ".y4m")
        _write_y4m(out, [(f.y, f.uv[..., 0], f.uv[..., 1]) for f in decoded], W, H)
        y4m.append(str(out))
    return ref, dis, y4m


@pytest.fixture(scope="module")
def jax_pair_scores(clip_pair):
    """The JAX CLI's JSON for the compressed pair, compiled once."""
    ref, dis, _ = clip_pair
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        assert jax_cli.main([ref, dis, "-m", "ssimulacra2", "-m", "psnr", "-m", "ssim",
                             "--output", "json", "--no-progress"]) == 0
    return json.loads(out.getvalue())


def _port_cli_json(args, capsys):
    capsys.readouterr()
    assert port_cli.main(args + ["--output", "json", "--no-progress", "--device", "cpu"]) == 0
    return json.loads(capsys.readouterr().out)


# -- Y4M, parsers, stats ------------------------------------------------------


def test_y4m_roundtrip_matches_jax(tmp_path, rng):
    w, h = 32, 24
    frames = [tuple(rng.integers(0, 255, s, dtype=np.uint16) for s in ((h, w), (h // 2, w // 2), (h // 2, w // 2)))
              for _ in range(3)]
    path = tmp_path / "t.y4m"
    _write_y4m(path, frames, w, h)
    got, want = Y4MFrameSource(open(path, "rb")), JaxY4M(open(path, "rb"))
    assert (got.width, got.height, got.depth, got.frame_count()) == (want.width, want.height, want.depth, 3)
    _assert_same_frames(_frames_of(got), _frames_of(want))


def test_y4m_10bit_fullrange_matches_jax(tmp_path, rng):
    frames = [tuple(rng.integers(0, 1023, s, dtype=np.uint16) for s in ((16, 16), (8, 8), (8, 8)))]
    path = tmp_path / "t10.y4m"
    _write_y4m(path, frames, 16, 16, depth=10, extra=" XCOLORRANGE=FULL")
    got, want = Y4MFrameSource(open(path, "rb")), JaxY4M(open(path, "rb"))
    assert got.depth == want.depth == 10 and got.full_range and want.full_range
    _assert_same_frames(_frames_of(got), _frames_of(want))


def test_ivf_roundtrip_matches_jax(tmp_path):
    path = tmp_path / "t.ivf"
    packets = [b"hello", b"world!!", b"\x00" * 17]
    with open(path, "wb") as f:
        f.write(b"DKIF" + struct.pack("<HH", 0, 32) + b"AV01" + struct.pack("<HH", 320, 240))
        f.write(struct.pack("<IIII", 25, 1, len(packets), 0))
        for i, p in enumerate(packets):
            f.write(struct.pack("<IQ", len(p), i) + p)
    with open(path, "rb") as f, open(path, "rb") as g:
        got, want = ivf.read_header(f), jax_ivf.read_header(g)
        assert asdict(got) == asdict(want) and got.codec == want.codec == "av1"
        assert list(ivf.iter_packets(f)) == list(jax_ivf.iter_packets(g)) == [(p, i) for i, p in enumerate(packets)]
    with pytest.raises(ValueError, match="not an IVF file"):
        ivf.read_header(io.BytesIO(b"DKIF" + bytes(10)))


def test_parse_sps_1080p_matches_jax():
    got, want = h264.parse_sps(_SPS_1080P), jax_h264.parse_sps(_SPS_1080P)
    assert asdict(got) == asdict(want)
    assert (got.width, got.height, got.depth) == (1920, 1080, 8)
    assert _cc((got.color_characteristics(), "")) == _cc((want.color_characteristics(), ""))


def test_annexb_iteration_matches_jax():
    data = b"\x00\x00\x00\x01" + _SPS_1080P + b"\x00\x00\x01" + b"\x68\xee\x3c\x80"
    assert list(h264.iter_annexb_nalus(data)) == list(jax_h264.iter_annexb_nalus(data))
    assert len(list(h264.iter_annexb_nalus(data))) == 2
    assert asdict(h264.find_sps(data)) == asdict(jax_h264.find_sps(data))


def test_avcc_to_annexb_matches_jax():
    pkt = b"\x00\x00\x00\x03abc" + b"\x00\x00\x00\x02de"
    assert h264.avcc_into_annexb(pkt, 4) == jax_h264.avcc_into_annexb(pkt, 4) == [
        b"\x00\x00\x00\x01abc", b"\x00\x00\x00\x01de"]


def _outcome(fn, *args):
    """A parser's result as a comparable value: its fields, or the exception."""
    try:
        r = fn(*args)
    except Exception as e:  # the parsers raise on truncated input: compare the kind
        return type(e).__name__
    return asdict(r) if r is not None else None


def test_bitstream_parsers_match_jax_on_seeded_bytes():
    """The SPS, AV1 sequence header and MPEG-2 sequence parsers give the same
    result (or the same exception) as the JAX package's on seeded bytes."""
    rng = np.random.default_rng(7)
    for _ in range(300):
        data = rng.integers(0, 256, int(rng.integers(1, 40)), dtype=np.uint8).tobytes()
        assert _outcome(h264.parse_sps, b"\x67" + data) == _outcome(jax_h264.parse_sps, b"\x67" + data)
        assert _outcome(av1.parse_sequence_header, data) == _outcome(jax_av1.parse_sequence_header, data)
        obus = bytes([0x0A, len(data)]) + data
        assert av1.find_sequence_header(obus) == jax_av1.find_sequence_header(obus) == data
        cp = b"\x81\x00\x0c\x00" + obus
        assert _outcome(av1.parse_codec_private, cp) == _outcome(jax_av1.parse_codec_private, cp)
        seq = b"junk" + h262.SEQ_HEADER + data + h262.EXTENSION + bytes([0x23]) + data
        assert _outcome(h262.parse_sequence, seq) == _outcome(jax_h262.parse_sequence, seq)


def test_h262_sequence_of_committed_ts_matches_jax():
    """The MPEG-2 sequence header of the committed 1080p TS."""
    data = (REPO / "turbo_metrics_tpu_torch" / "tools" / "clips" / "dis_mpeg2.ts").read_bytes()[:65536]
    got, want = h262.parse_sequence(data), jax_h262.parse_sequence(data)
    assert asdict(got) == asdict(want)
    assert (got.width, got.height) == (1920, 1080)


def test_stats_matches_jax():
    vals = [0.0, 1.0, 3.0, 4.0, 2.5]
    assert asdict(Stats.compute(vals)) == asdict(JaxStats.compute(vals))


# -- MKV demuxer ----------------------------------------------------------------


def test_mkv_demuxer_matches_jax(vp9_mkv):
    got, want = mkv.MkvDemuxer(open(vp9_mkv, "rb")), jax_mkv.MkvDemuxer(open(vp9_mkv, "rb"))
    assert asdict(got.video_track) == asdict(want.video_track)
    assert got.video_track.codec == "vp9" and (got.video_track.pixel_width, got.video_track.pixel_height) == (W, H)
    assert got.frame_count_estimate() == want.frame_count_estimate()
    pg, pw = list(got.packets()), list(want.packets())
    assert [asdict(p) for p in pg] == [asdict(p) for p in pw]
    assert len(pg) == 5 and all(p.data for p in pg)


def test_mkv_ebml_lacing_sizes_matches_jax():
    frames = [b"a" * 500, b"b" * 400, b"c" * 123]
    delta = 8091  # -100 as a signed 2-byte vint
    block = (b"\x81\x00\x00" + bytes([0x86, 2]) + bytes([0x40 | (500 >> 8), 500 & 0xFF])
             + bytes([0x40 | (delta >> 8), delta & 0xFF]) + b"".join(frames))
    out = []
    for mod in (mkv, jax_mkv):
        demux = mod.MkvDemuxer.__new__(mod.MkvDemuxer)
        demux.timestamp_scale = 1
        demux._cluster_ts = 0
        out.append([asdict(p) for p in demux._parse_block(block, 1, simple=True)])
    assert out[0] == out[1]
    assert [p["data"] for p in out[0]] == frames


def test_mkv_unknown_size_cluster_matches_jax():
    def simpleblock(track, ts, data):
        return _ebml(0xA3, bytes([0x80 | track]) + ts.to_bytes(2, "big") + b"\x80" + data)

    track_entry = _ebml(0xAE, _ebml(0xD7, b"\x01") + _ebml(0x83, b"\x01") + _ebml(0x86, b"V_VP9")
                        + _ebml(0xE0, _ebml(0xB0, b"\x40") + _ebml(0xBA, b"\x30")))
    data = (_ebml(0x1A45DFA3, b"") + _ebml(0x18538067, b"", unknown_size=True)
            + _ebml(0x1549A966, _ebml(0x2AD7B1, (1_000_000).to_bytes(3, "big")))
            + _ebml(0x1654AE6B, track_entry)
            + _ebml(0x1F43B675, b"", unknown_size=True) + _ebml(0xE7, b"\x00")
            + simpleblock(1, 0, b"frame0") + simpleblock(1, 40, b"frame1")
            + _ebml(0x1F43B675, _ebml(0xE7, b"\x50") + simpleblock(1, 0, b"frame2")))
    got, want = mkv.MkvDemuxer(io.BytesIO(data)), jax_mkv.MkvDemuxer(io.BytesIO(data))
    assert asdict(got.video_track) == asdict(want.video_track)
    pg = [asdict(p) for p in got.packets()]
    assert pg == [asdict(p) for p in want.packets()]
    assert [p["data"] for p in pg] == [b"frame0", b"frame1", b"frame2"]
    assert pg[2]["timestamp_ns"] == 0x50 * 1_000_000


# -- the native shim ------------------------------------------------------------


def test_shim_built_in_the_port_build_dir():
    """The port's shim: its own build under _build/, keyed on the source."""
    native.SHIM.get()
    path = native.SHIM.path
    assert path.parent == REPO / "turbo_metrics_tpu_torch" / "_build"
    assert path.name.startswith("libturbodemux_") and path.is_file()
    assert native.SHIM_SOURCE == REPO / "native" / "turbodemux.cpp"
    assert native.native_available()
    probe_ = native.libav_probe()
    assert probe_["missing"] == [] and probe_["compiler"]


def test_shim_concurrent_first_builds(tmp_path):
    """Three processes building the shim at once into an empty directory all
    load it; one library is published and no temporary file is left."""
    code = (
        "import sys; from pathlib import Path; from turbo_metrics_tpu_torch.io import native;"
        f"native.BUILD_DIR = Path({str(tmp_path)!r}); lib = native.DemuxLibrary(); lib.get();"
        "print(lib.path.name)"
    )
    procs = [subprocess.Popen([sys.executable, "-c", code], cwd=REPO, stdout=subprocess.PIPE, text=True)
             for _ in range(3)]
    names = {p.communicate(timeout=120)[0].strip() for p in procs}
    assert all(p.returncode == 0 for p in procs)
    assert len(names) == 1
    assert sorted(f.name for f in tmp_path.iterdir()) == [names.pop()]


def test_shim_errors_quote_the_compiler_and_name_libraries(tmp_path, monkeypatch):
    """A shim that does not build: the error quotes the compiler's message
    and names the libav libraries the probe finds missing; no compiler: the
    error says so.  Nothing is published."""
    broken = tmp_path / "turbodemux.cpp"
    broken.write_text("#include <libavcodec/no_such_header.h>\n")
    monkeypatch.setattr(native, "SHIM_SOURCE", broken)
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "build")
    real_probe = native.libav_probe

    def probe_missing():
        found = real_probe()
        found["missing"] = list(native.LIBAV)
        return found

    monkeypatch.setattr(native, "libav_probe", probe_missing)
    err = native.DemuxLibrary().error()
    assert "no_such_header.h" in err and "exited" in err
    assert all(name in err for name in native.LIBAV)
    assert list((tmp_path / "build").iterdir()) == []
    monkeypatch.setenv("CXX", "no-such-compiler-for-the-shim")
    err = native.DemuxLibrary().error()
    assert "no C++ compiler" in err


def test_native_unavailable_raises_named_error(vp9_mkv, monkeypatch):
    """NativeVideoSource without a shim: a RuntimeError naming the reason."""
    lib = native.DemuxLibrary()
    lib._error = "libav libraries missing (no shared object, no pkg-config entry): libavformat"
    monkeypatch.setattr(native, "SHIM", lib)
    with pytest.raises(RuntimeError, match="native demuxer unavailable: .*libavformat"):
        native.NativeVideoSource(vp9_mkv)
    assert not native.native_available() and native.load_library() is None


def test_native_video_source_matches_jax(vp9_mkv):
    got, want = native.NativeVideoSource(vp9_mkv), jax_native.NativeVideoSource(vp9_mkv)
    assert (got.width, got.height) == (want.width, want.height) == (W, H)
    assert str(got.format_id()) == str(want.format_id())
    assert _cc(got.color_characteristics()) == _cc(want.color_characteristics())
    assert got.frame_count() == want.frame_count()
    assert [getattr(got.info, f) for f, _ in native._TmInfo._fields_] == [
        getattr(want.info, f) for f, _ in jax_native._TmInfo._fields_]
    fg = _frames_of(got)
    _assert_same_frames(fg, _frames_of(want))
    assert len(fg) == 5 and fg[0].kind == "yuv420" and fg[0].uv.shape == (H // 2, W // 2, 2)


def test_native_midstream_reconfiguration_matches_jax(reschange_ts):
    """The -3 reconfiguration: the same changes and frames in the same order."""
    def run(src, changed):
        events = []
        while True:
            try:
                f = src.get_frame()
            except changed as e:
                events.append(("change", e.width, e.height, src.width, src.height))
                continue
            if f is None:
                return events
            events.append(f)

    got = run(native.NativeVideoSource(reschange_ts), ResolutionChanged)
    want = run(jax_native.NativeVideoSource(reschange_ts), JaxResolutionChanged)
    assert [e for e in got if isinstance(e, tuple)] == [e for e in want if isinstance(e, tuple)] == [
        ("change", 128, 96, 128, 96)]
    assert [i for i, e in enumerate(got) if isinstance(e, tuple)] == [
        i for i, e in enumerate(want) if isinstance(e, tuple)]
    _assert_same_frames([e for e in got if not isinstance(e, tuple)], [e for e in want if not isinstance(e, tuple)])
    sizes = [(e.width, e.height) for e in got if not isinstance(e, tuple)]
    assert set(sizes[:3]) == {(64, 48)} and set(sizes[-4:]) == {(128, 96)}


def test_native_stream_input_matches_jax(vp9_mkv):
    """AVIO callbacks: a seekable BytesIO and a non-seekable pipe."""
    data = Path(vp9_mkv).read_bytes()

    class Pipe:
        def __init__(self, b):
            self._b = io.BytesIO(b)

        def read(self, n=-1):
            return self._b.read(n)

        def seekable(self):
            return False

    want = _frames_of(jax_native.NativeVideoSource(vp9_mkv))
    for stream in (io.BytesIO(data), Pipe(data)):
        src = native.NativeVideoSource(stream=stream)
        assert (src.width, src.height) == (W, H) and not src.can_seek()
        _assert_same_frames(_frames_of(src), want)
        src.close()


def test_stdin_video_create_source_matches_jax(vp9_mkv, monkeypatch):
    out = []
    for create in (probe.create_source, jax_probe.create_source):
        class FakeStdin:
            buffer = open(vp9_mkv, "rb")

        monkeypatch.setattr("sys.stdin", FakeStdin)
        src = create("-", use_stdin=True)
        assert (src.width, src.height) == (W, H)
        out.append(_frames_of(src))
        FakeStdin.buffer.close()
    _assert_same_frames(*out)
    assert len(out[0]) == 5


def test_mkv_container_cross_check_matches_jax(vp9_mkv):
    got, want = probe._mkv_container_meta(vp9_mkv), jax_probe._mkv_container_meta(vp9_mkv)
    assert {k: v for k, v in got.items() if k != "cc"} == {k: v for k, v in want.items() if k != "cc"}
    assert _cc((got["cc"], "")) == _cc((want["cc"], ""))
    assert got["codec"] == "vp9" and (got["width"], got["height"]) == (W, H)
    src = probe.create_source(vp9_mkv)
    assert isinstance(src, native.NativeVideoSource) and src._meta == got


def test_no_backend_error_describes_stream(vp9_mkv, monkeypatch):
    """Without any decode backend both packages raise a RuntimeError that
    names the container, codec and geometry."""
    monkeypatch.setattr(native, "native_available", lambda: False)
    monkeypatch.setattr(opencv_source, "opencv_available", lambda: False)
    import turbo_metrics_tpu.io.opencv_source as jax_ocv

    monkeypatch.setattr(jax_native, "native_available", lambda: False)
    monkeypatch.setattr(jax_ocv, "opencv_available", lambda: False)
    with pytest.raises(RuntimeError) as got:
        probe.create_source(vp9_mkv)
    with pytest.raises(RuntimeError) as want:
        jax_probe.create_source(vp9_mkv)
    for msg in (str(got.value), str(want.value)):
        assert "vp9" in msg and f"{W}x{H}" in msg and "Matroska" in msg


def test_color_override_preserves_pushback_matches_jax(reschange_ts):
    src = ColorOverrideSource(native.NativeVideoSource(reschange_ts), crange="full")
    sizes = []
    while True:
        try:
            f = src.get_frame()
        except ResolutionChanged:
            continue
        if f is None:
            break
        assert f.full_range
        sizes.append((f.width, f.height))
    want = []
    jsrc = jax_native.NativeVideoSource(reschange_ts)
    while True:
        try:
            f = jsrc.get_frame()
        except JaxResolutionChanged:
            continue
        if f is None:
            break
        want.append((f.width, f.height))
    assert sizes == want and (64, 48) in sizes and (128, 96) in sizes


# -- OpenCV fallback -------------------------------------------------------------


def test_opencv_source_matches_jax(vp9_mkv):
    import turbo_metrics_tpu.io.opencv_source as jax_ocv

    got, want = opencv_source.OpenCvVideoSource(vp9_mkv), jax_ocv.OpenCvVideoSource(vp9_mkv)
    assert (got.width, got.height, got.frame_count()) == (want.width, want.height, want.frame_count())
    assert str(got.format_id()) == str(want.format_id())
    assert _cc(got.color_characteristics()) == _cc(want.color_characteristics()) == ("BT709", "IDENTITY", "SRGB", "full")
    fg = _frames_of(got)
    _assert_same_frames(fg, _frames_of(want))
    assert len(fg) == 5 and fg[0].rgb.shape == (H, W, 3)


def test_probe_falls_back_to_opencv_with_warning(vp9_mkv, monkeypatch, caplog):
    """The JAX package's order: native, then OpenCV (paths only), with a
    warning that names the lower colour fidelity."""
    import turbo_metrics_tpu.io.opencv_source as jax_ocv

    monkeypatch.setattr(native, "native_available", lambda: False)
    monkeypatch.setattr(jax_native, "native_available", lambda: False)
    with caplog.at_level(logging.WARNING, logger="turbo_metrics_tpu_torch"):
        src = probe.create_source(vp9_mkv)
    assert isinstance(src, opencv_source.OpenCvVideoSource)
    assert "lower colour fidelity" in caplog.text and vp9_mkv in caplog.text
    jsrc = jax_probe.create_source(vp9_mkv)
    assert isinstance(jsrc, jax_ocv.OpenCvVideoSource)
    _assert_same_frames(_frames_of(src), _frames_of(jsrc))


# -- images ------------------------------------------------------------------------


def _both(path):
    got, want = probe.create_source(path), jax_probe.create_source(path)
    assert isinstance(got, ImageFrameSource)
    assert (got.width, got.height, got.frame_count()) == (want.width, want.height, want.frame_count())
    assert str(got.format_id()) == str(want.format_id())
    assert _cc(got.color_characteristics()) == _cc(want.color_characteristics())
    return got, want


def test_probe_image_and_video_matches_jax(tmp_path, vp9_mkv, rng):
    from PIL import Image

    img = (rng.random((20, 30, 3)) * 255).astype(np.uint8)
    p = tmp_path / "t.png"
    Image.fromarray(img).save(p)
    got, want = _both(p)
    fg = _frames_of(got)
    _assert_same_frames(fg, _frames_of(want))
    np.testing.assert_array_equal(fg[0].rgb, img)
    v = probe.create_source(vp9_mkv)
    assert isinstance(v, native.NativeVideoSource) and (v.width, v.height) == (W, H)


def test_gif_multiframe_matches_jax(tmp_path, rng):
    from PIL import Image

    imgs = [Image.fromarray((rng.random((16, 16, 3)) * 255).astype(np.uint8)) for _ in range(4)]
    p = tmp_path / "anim.gif"
    imgs[0].save(p, save_all=True, append_images=imgs[1:], duration=100, loop=0)
    got, want = _both(p)
    fg = _frames_of(got)
    _assert_same_frames(fg, _frames_of(want))
    assert len(fg) == 4 and fg[0].rgb.shape == (16, 16, 3)


def test_16bit_png_matches_jax(tmp_path, rng):
    from PIL import Image

    gray = rng.integers(0, 65536, (12, 14), dtype=np.uint16)
    p = tmp_path / "t16.png"
    Image.fromarray(gray, mode="I;16").save(p)
    got, want = _both(p)
    fg = _frames_of(got)
    _assert_same_frames(fg, _frames_of(want))
    assert fg[0].depth == 16 and fg[0].rgb.dtype == np.uint16
    np.testing.assert_array_equal(fg[0].rgb[..., 0], gray)


def test_skip_frames_image_source_matches_jax(tmp_path, rng):
    from PIL import Image

    imgs = [Image.fromarray((rng.random((8, 8, 3)) * 255).astype(np.uint8)) for _ in range(3)]
    p = tmp_path / "a.gif"
    imgs[0].save(p, save_all=True, append_images=imgs[1:], duration=100)
    got, want = _both(p)
    got.skip_frames(2)
    want.skip_frames(2)
    fg = _frames_of(got)
    _assert_same_frames(fg, _frames_of(want))
    assert len(fg) == 1


# -- chunked decode ----------------------------------------------------------------


def _vp9_ramp(tmp_path, n):
    frames = []
    for i in range(n):
        img = np.zeros((H, W, 3), np.uint8)
        img[:, :, 0] = (i * 11) % 256
        img[:, : W // 2, 1] = (i * 7) % 256
        frames.append(img)
    return _write_clip(tmp_path / f"ramp{n}.mkv", "VP90", frames)


def test_chunked_decode_exact_order_matches_jax(tmp_path):
    """ChunkedVideoSource gives the JAX decoder's frames in its order, for
    any workers/chunk combination and after skip_frames."""
    path = _vp9_ramp(tmp_path, 23)
    seq = _frames_of(jax_native.NativeVideoSource(path))
    assert len(seq) == 23
    for workers, chunk in [(2, 5), (3, 8), (2, 64)]:
        _assert_same_frames(_frames_of(ChunkedVideoSource(path, workers=workers, chunk=chunk)), seq)
    cs = ChunkedVideoSource(path, workers=2, chunk=4)
    cs.skip_frames(7)
    assert cs.frame_count() == 0 or cs.frame_count() == 16
    _assert_same_frames(_frames_of(cs), seq[7:])


def test_seek_to_frame_matches_jax(tmp_path):
    path = _vp9_ramp(tmp_path, 17)
    seq = _frames_of(jax_native.NativeVideoSource(path))
    src = native.NativeVideoSource(path)
    assert src.can_seek()
    for target in (11, 3, 16, 0):
        assert src.seek_to_frame(target)
        _assert_same_frames([src.get_frame()], [seq[target]])
    assert not src.seek_to_frame(100)


@pytest.mark.parametrize("n", [5, 16])
def test_chunked_decode_mpeg_ts(tmp_path, n):
    """MPEG-TS starts at a nonzero PTS, and its seeks can overshoot: every
    frame is reachable by seek_to_frame, and ChunkedVideoSource gives one
    decoder's frames (the JAX package's pool returns no frame of the
    5-frame TS: its seeks decode nothing and count as the end)."""
    frames = torch_io_clips.source_frames(W, H, n)
    path = _write_clip(tmp_path / f"c{n}.ts", "MPG2", frames)
    seq = _frames_of(jax_native.NativeVideoSource(path))
    assert len(seq) == n
    src = native.NativeVideoSource(path)
    assert src.can_seek() and int(src.info.start_pts) > 0
    for target in (n - 1, 0, n // 2):
        assert src.seek_to_frame(target), target
        _assert_same_frames([src.get_frame()], [seq[target]])
    assert not src.seek_to_frame(n + 30)
    for workers, chunk in [(2, 3), (3, 4)]:
        _assert_same_frames(_frames_of(ChunkedVideoSource(path, workers=workers, chunk=chunk)), seq)


# -- CLIs ---------------------------------------------------------------------------


def test_cli_compressed_pair_matches_y4m_and_jax(clip_pair, jax_pair_scores, capsys):
    """A VP9 MKV reference against an MPEG-2 TS: the port's CLI on the CPU
    gives the scores of the Y4M files of the same decoded frames bit for bit,
    with --decode-workers 2 too, and the JAX CLI's within the slice
    tolerances."""
    ref, dis, y4m = clip_pair
    metrics = ["-m", "ssimulacra2", "-m", "psnr", "-m", "ssim"]
    got = _port_cli_json([ref, dis, *metrics], capsys)
    assert got["frame_count"] == jax_pair_scores["frame_count"] == 5
    for args in ([*y4m, *metrics], [ref, dis, *metrics, "--decode-workers", "2"]):
        again = _port_cli_json(args, capsys)
        for name in ATOL:
            assert again[name]["scores"] == got[name]["scores"], (args, name)
    for name, atol in ATOL.items():
        np.testing.assert_allclose(got[name]["scores"], jax_pair_scores[name]["scores"], rtol=0, atol=atol,
                                   err_msg=name)
    # The port's scores against an f64 evaluation of its plain chain on the
    # same linear RGB (measured 0.0017 apart).
    from turbo_metrics_tpu_torch.engine import ConvertSpec
    from turbo_metrics_tpu_torch.models.ssimulacra2 import Ssimulacra2, ssimulacra2_subscores
    from turbo_metrics_tpu_torch.ops import colorspace

    lin = []
    for path in (ref, dis):
        src = native.NativeVideoSource(path)
        frames = _frames_of(src)
        spec = ConvertSpec.for_frame(frames[0], *src.color_characteristics())
        y, uv = (torch.from_numpy(np.stack([getattr(f, k) for f in frames])) for k in ("y", "uv"))
        lin.append(colorspace.yuv420_to_linear_rgb(y, uv, matrix=spec.matrix, transfer=spec.transfer,
                                                   full_range=spec.full_range).double())
    model = Ssimulacra2(W, H, device="cpu")
    f64 = model.score(ssimulacra2_subscores(*lin, num_scales=model.num_scales, taps=model.taps.double(),
                                            opsin=model.opsin.double()).float())
    np.testing.assert_allclose(got["ssimulacra2"]["scores"], f64, rtol=0, atol=3e-3)


def test_cli_image_pair_matches_jax(tmp_path, rng, capsys):
    """A PNG pair (packed RGB, the engine's RGB conversion) through both CLIs."""
    from PIL import Image

    yy, xx = np.mgrid[0:H, 0:W]
    base = np.stack([128 + 90 * np.sin(xx / 9.0) * np.cos(yy / 7.0), 128 + 60 * np.cos(xx / 5.0),
                     128 + 40 * np.sin((xx + yy) / 11.0)], axis=-1)
    ref = np.clip(base, 0, 255).astype(np.uint8)
    dis = np.clip(ref.astype(np.int16) + rng.integers(-9, 10, ref.shape), 0, 255).astype(np.uint8)
    paths = [tmp_path / "ref.png", tmp_path / "dis.png"]
    for p, a in zip(paths, (ref, dis)):
        Image.fromarray(a).save(p)
    args = [str(paths[0]), str(paths[1]), "-m", "ssimulacra2", "-m", "psnr", "--output", "json", "--no-progress"]
    assert jax_cli.main(args) == 0
    want = json.loads(capsys.readouterr().out)
    got = _port_cli_json(args[:-3], capsys)
    assert got["frame_count"] == want["frame_count"] == 1
    for name in ("ssimulacra2", "psnr"):
        np.testing.assert_allclose(got[name]["scores"], want[name]["scores"], rtol=0, atol=ATOL[name])


def test_cli_segmented_resolution_change_matches_jax(reschange_ts, capsys):
    """The CLI's segment loop on a real reconfiguring TS: both segments
    scored and merged, as the JAX CLI does."""
    args = [reschange_ts, reschange_ts, "-m", "psnr", "--output", "json", "--no-progress"]
    assert jax_cli.main(args) == 0
    want = json.loads(capsys.readouterr().out)
    got = _port_cli_json(args[:-3], capsys)
    # The demuxer drops a corrupt packet where the two TS files meet: 3 + 4.
    assert got["frame_count"] == want["frame_count"] >= 6
    assert got["psnr"]["scores"] == want["psnr"]["scores"] == [float("inf")] * got["frame_count"]


def test_cli_decode_workers_warns_for_other_inputs(clip_pair, capsys, caplog):
    """--decode-workers engages on seekable native files only; Y4M gets the
    warning and the same scores."""
    ref, dis, y4m = clip_pair
    with caplog.at_level(logging.WARNING, logger="turbo_metrics_tpu_torch"):
        got = _port_cli_json([*y4m, "-m", "psnr", "--decode-workers", "3"], capsys)
    assert caplog.text.count("not seekable-CFR; --decode-workers ignored") == 2
    assert got["frame_count"] == 5


# -- the committed clips of chip_smoke.py's phase 4g -------------------------------


def test_committed_clips_record_matches_jax_decode():
    """clips.json equals what the JAX package decodes from the committed
    clips now, and the port decodes the same planes."""
    clips = REPO / "turbo_metrics_tpu_torch" / "tools" / "clips"
    record = json.loads((clips / torch_io_clips.RECORD).read_text())
    assert [record["reference"], record["distorted"]] == [n for n, _ in torch_io_clips.CLIP_FILES]
    for name, rec in record["clips"].items():
        path = clips / name
        assert path.stat().st_size == rec["bytes"]
        assert torch_io_clips.native_record(path) == rec["native"]
        assert torch_io_clips.opencv_record(path) == rec["opencv"]
        planes = [torch_io_clips.frame_planes(f) for f in _frames_of(native.NativeVideoSource(path))]
        assert planes == rec["native"]["planes_sha256"]
        assert len(planes) == record["source"]["frames"] == 16
    assert sum(rec["bytes"] for rec in record["clips"].values()) < 1 << 20
    for scores in record["ssimulacra2_jax_cpu"].values():
        assert len(scores) == 16 and all(np.isfinite(scores))
