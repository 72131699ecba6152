# The port's F3DZ codec (forge3d_tpu_torch.codec) against forge3d_tpu.codec
# on the CPU: the device lane's plain C1 (decompress_dem_device(...,
# device="cpu")) on full-tile pages against the C++ and Python lanes of both
# packages and against JAX's device lane, the routing of partial-tile pages,
# fail-closed decoding, the host codec's bytes and reports, and the corpus
# manifest.
#
# Pages: tests/test_codec_corpus.py's smooth, noisy and extreme recipes and
# tests/test_codec_device.py's spikes, at 256^2 (one tile) and 256x512 (two),
# at max_error 0.05 and 0.5: every F3DZ page whose sides are multiples of
# the 256-pixel tile goes through C1.
#
# Gates, all exact:
# - the port's device lane byte-identical to the C++ lane and to the Python
#   lane of both packages, within max_error of the heights;
# - its integers equal JAX's: _tile_decoder with step (1.0, 0.0) returns
#   the quantized heights q as float32, exact for |q| < 2^24;
# - the reference's fault pinned: JAX's device heights differ from the
#   port's exactly where they differ from the C++ lane, each by one ulp
#   (JAX scales by the float32 sum q*step_hi + q*step_lo; the C++ lane by
#   one double product rounded once), on the counts of ROADMAP queue 3.
import hashlib
import json
from pathlib import Path

import numpy as np
import pytest
import torch

import forge3d_tpu as f3d
from forge3d_tpu.codec import f3dz as jf3dz
from forge3d_tpu.codec import f3dz_device as jdev
from forge3d_tpu.codec.f3dz_pylane import decompress_dem_pylane as jax_pylane

import forge3d_tpu_torch as f3t
from forge3d_tpu_torch import errors as terr
from forge3d_tpu_torch.codec import f3dz as tf3dz
from forge3d_tpu_torch.codec import f3dz_device as tdev
from forge3d_tpu_torch.codec.f3dz_pylane import decompress_dem_pylane as port_pylane

torch.set_num_threads(1)

SHAPES = {"256x256": (256, 256), "256x512": (256, 512)}
EPS = (0.05, 0.5)
# JAX's device heights that differ from the C++ lane's at 256^2 (ROADMAP
# queue 3, faults of the reference)
JAX_ULP_DIFFS = {("smooth", 0.05): 8442, ("smooth", 0.5): 1076, ("noisy", 0.05): 11024,
                 ("noisy", 0.5): 17237, ("extreme", 0.05): 20387, ("extreme", 0.5): 0,
                 ("spikes", 0.05): 0, ("spikes", 0.5): 0}


def recipe(name, h, w):
    y, x = np.mgrid[0:h, 0:w].astype(np.float32)
    if name == "smooth":     # test_codec_corpus.py
        v = 800 + 120 * np.sin(x * 0.02) * np.cos(y * 0.017)
    elif name == "noisy":
        v = np.random.default_rng(20260819).normal(1500, 40, (h, w))
    elif name == "extreme":
        v = np.where(x > 128, 8848.0, -430.5) + y * 0.01
    else:                    # test_codec_device.py's spikes
        v = np.where(np.random.default_rng(11).random((h, w)) < 0.01, 9000.0, 10.0)
    return np.asarray(v, np.float32)


PAGES = [(name, shape, eps) for name in ("smooth", "noisy", "extreme", "spikes")
         for shape in SHAPES for eps in EPS]
IDS = [f"{n}-{s}-{e}" for n, s, e in PAGES]


@pytest.fixture(scope="module")
def pages():
    """Every page's heights, stream and lanes: the C++ lane, JAX's device
    lane and the port's device lane (plain C1)."""
    out = {}
    for name, shape, eps in PAGES:
        h = recipe(name, *SHAPES[shape])
        blob = tf3dz.compress_dem(h, eps)
        out[(name, shape, eps)] = dict(
            heights=h, blob=blob, cpp=tf3dz.decompress_dem(blob),
            jax=jdev.decompress_dem_device(blob),
            port=tdev.decompress_dem_device(blob, device="cpu"))
    return out


def bits(a):
    return np.ascontiguousarray(a, np.float32).view(np.uint32)


@pytest.mark.parametrize("page", PAGES, ids=IDS)
def test_device_lane_equals_cpp_and_python_lanes(pages, page):
    p = pages[page]
    blob, port = p["blob"], p["port"]
    assert port.dtype == np.float32 and port.shape == p["heights"].shape
    for lane in (p["cpp"], jf3dz.decompress_dem(blob), port_pylane(blob), jax_pylane(blob)):
        np.testing.assert_array_equal(bits(port), bits(lane))
    err = np.abs(port.astype(np.float64) - p["heights"].astype(np.float64))
    assert float(err.max()) <= float(np.float32(page[2]))


def jax_inputs(page: tdev.TilePage):
    """JAX's _tile_decoder arguments, from the port's parse."""
    slot2sym = np.stack([np.repeat(np.arange(256), f) for f in page.freq]).astype(np.int32)
    freq = page.freq.astype(np.uint32)
    cum = np.zeros_like(freq)
    np.cumsum(freq[:, :-1], axis=1, out=cum[:, 1:])
    return (page.stream, page.lens.astype(np.uint32), slot2sym, freq, cum,
            page.extras.view(np.uint32))


@pytest.mark.parametrize("page", PAGES, ids=IDS)
def test_integers_equal_jax(pages, page):
    """The residuals and quantized heights of C1 equal JAX's: both scale by
    1.0, JAX's float32 q exact below 2^24."""
    tp = tdev.parse_page(pages[page]["blob"])
    cap, ecap = max(4, int(tp.lens.max())), tp.extras.shape[1]   # JAX's padding
    fn = jdev._tile_decoder(256, 256 * 256, cap, ecap)
    stream, *rest = jax_inputs(tp)
    jq = np.asarray(fn(stream[:, :cap], *rest, np.float32(1.0), np.float32(0.0)))
    d = tdev.rans_decode(*tp.tensors("cpu"))
    q = tdev.med_reconstruct(d, tp.ntx, tp.nty, 1.0).numpy()
    assert float(np.abs(q).max()) < 2 ** 24
    np.testing.assert_array_equal(q, tdev._place(torch.from_numpy(np.array(jq)), tp.ntx,
                                                  tp.nty).numpy())


@pytest.mark.parametrize("page", PAGES, ids=IDS)
def test_jax_device_lane_fault_is_one_ulp(pages, page):
    """JAX's device lane differs from the port's exactly where it differs
    from the C++ lane, each time by one ulp."""
    p = pages[page]
    jax_b, port_b, cpp_b = bits(p["jax"]), bits(p["port"]), bits(p["cpp"])
    differ = jax_b != port_b
    np.testing.assert_array_equal(differ, jax_b != cpp_b)
    ulps = np.abs(jax_b[differ].astype(np.int64) - port_b[differ].astype(np.int64))
    assert (ulps == 1).all()
    name, shape, eps = page
    if shape == "256x256":
        assert int(differ.sum()) == JAX_ULP_DIFFS[(name, eps)]


@pytest.mark.parametrize("shape", [(64, 64), (257, 257), (256, 300)])
def test_partial_tile_pages_route_through_the_python_lane(monkeypatch, shape):
    h = recipe("noisy", *shape)
    blob = tf3dz.compress_dem(h, 0.05)
    assert blob == jf3dz.compress_dem(h, 0.05)
    monkeypatch.setattr(tdev, "rans_decode_plain", None)    # C1 is not reached
    got = tdev.decompress_dem_device(blob, device="cpu")
    for lane in (port_pylane(blob), jdev.decompress_dem_device(blob), tf3dz.decompress_dem(blob)):
        np.testing.assert_array_equal(bits(got), bits(lane))


def test_flipped_byte_fails_closed():
    h = recipe("smooth", 256, 256)
    blob = bytearray(tf3dz.compress_dem(h, 0.1))
    blob[60] ^= 0xFF   # inside the first tile record
    for fn in (lambda b: tdev.decompress_dem_device(b, device="cpu"), tf3dz.decompress_dem,
               port_pylane):
        with pytest.raises(tf3dz.F3dzError):
            fn(bytes(blob))
    with pytest.raises(tf3dz.F3dzError, match="truncated"):
        tdev.decompress_dem_device(bytes(blob[:len(blob) // 2]), device="cpu")
    with pytest.raises(tf3dz.F3dzError, match="magic"):
        tdev.decompress_dem_device(b"\0" * 64, device="cpu")
    assert issubclass(tf3dz.F3dzError, terr.RenderError)


@pytest.mark.parametrize("max_error", [1.0, 0.1, 0.01])
def test_round_trip_equals_jax(max_error):
    """examples/dem_compression_f3dz.py's page: the same bytes, heights and
    verify_dem reports in both packages; the header probe too."""
    n = 512
    y, x = np.mgrid[0:n, 0:n].astype(np.float32)
    dem = (900.0 + 220.0 * np.sin(x * 0.015) * np.cos(y * 0.012)
           + 6.0 * np.random.default_rng(11).standard_normal((n, n))).astype(np.float32)
    blob = f3t.compress_dem(dem, max_error=max_error)
    assert blob == f3d.compress_dem(dem, max_error=max_error)
    np.testing.assert_array_equal(bits(f3t.decompress_dem(blob)), bits(f3d.decompress_dem(blob)))
    assert f3t.verify_dem(blob, dem) == f3d.verify_dem(blob, dem)
    assert f3t.verify_dem(blob, dem)["ok"]
    assert tf3dz.f3dz_info(blob) == jf3dz.f3dz_info(blob)
    assert f3t.verify_dem(blob, dem[:, :-1]) == f3d.verify_dem(blob, dem[:, :-1])


def test_corpus_hashes_match_the_golden_manifest():
    """tests/test_codec_corpus.py's 257^2 corpus through the port's encoder
    hashes to the committed manifest."""
    rng = np.random.default_rng(20260819)
    y, x = np.mgrid[0:257, 0:257].astype(np.float32)
    corpus = {
        "smooth": 800 + 120 * np.sin(x * 0.02) * np.cos(y * 0.017),
        "ridged": np.abs(np.sin(x * 0.11)) * 90 + y * 0.4,
        "stepped": np.floor(x / 16) * 25.0 + np.floor(y / 32) * 12.5,
        "noisy": rng.normal(1500, 40, (257, 257)),
        "extreme": np.where(x > 128, 8848.0, -430.5) + y * 0.01,
        "plateau": np.full((257, 257), 1234.5),
    }
    hashes = {f"{name}@{eps}": hashlib.sha256(
        tf3dz.compress_dem(np.asarray(dem, np.float32), eps)).hexdigest()
        for name, dem in corpus.items() for eps in EPS}
    manifest = Path(__file__).parent / "goldens" / "f3dz_corpus.json"
    assert hashes == json.loads(manifest.read_text())


def test_encoder_refusals_match_jax():
    for bad, eps in ((np.full((4, 4), np.nan, np.float32), 0.1),
                     (np.zeros((4, 4, 2), np.float32), 0.1), (np.zeros((4, 4), np.float32), 0.0)):
        with pytest.raises(tf3dz.F3dzError) as e:
            tf3dz.compress_dem(bad, eps)
        with pytest.raises(jf3dz.F3dzError) as j:
            jf3dz.compress_dem(bad, eps)
        assert str(e.value) == str(j.value)


def test_kernel_wrappers_refuse_non_cuda_tensors():
    tp = tdev.parse_page(tf3dz.compress_dem(recipe("smooth", 256, 256), 0.5))
    meta = [torch.empty(a.shape, dtype=torch.as_tensor(a).dtype, device="meta")
            for a in (tp.stream, tp.lens, tp.freq, tp.extras)]
    before = (tdev.rans_decode.launches, tdev.med_reconstruct.launches)
    with pytest.raises(ValueError, match="CUDA"):
        tdev.rans_decode(*meta)
    with pytest.raises(ValueError, match="CUDA"):
        tdev.med_reconstruct(torch.empty((1, 65536), dtype=torch.int32, device="meta"), 1, 1, 0.1)
    assert (tdev.rans_decode.launches, tdev.med_reconstruct.launches) == before


def test_device_lane_defaults_to_cuda():
    blob = tf3dz.compress_dem(recipe("smooth", 256, 256), 0.5)
    if torch.cuda.is_available():   # the default runs the kernels
        np.testing.assert_array_equal(bits(tdev.decompress_dem_device(blob)),
                                      bits(tf3dz.decompress_dem(blob)))
    else:
        with pytest.raises(terr.DeviceError):
            tdev.decompress_dem_device(blob)


def test_top_level_names_resolve_as_in_jax():
    from forge3d_tpu_torch.codec import bc

    assert f3t.compress_dem is tf3dz.compress_dem
    assert f3t.decompress_dem is tf3dz.decompress_dem
    assert f3t.verify_dem is tf3dz.verify_dem
    assert f3t.codec.decompress_dem_device is tdev.decompress_dem_device
    for name in ("encode_bc7_rgba8", "decode_bc7", "encode_bc5_rg8", "decode_bc5"):
        assert getattr(f3t, name) is getattr(bc, name)
        assert callable(getattr(f3d, name))
    assert sorted(f3t.codec.__all__) == sorted(f3d.codec.__all__)
