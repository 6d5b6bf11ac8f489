"""The port's native JPEG decode (``jarvis_hybridnet_torch/native``:
``probe_jpeg``, ``decode_jpeg``, ``decode_batch``, ``decode_crop_batch``
and ``FramesetPipeline``, built from the port's copy of ``jarvis_host.cpp``)
bit-equal to the JAX package's native functions on the same seeded JPEGs.
Skipped only where the JAX package's own library does not build (no g++ or
libjpeg); where it builds, the port's must too."""

import numpy as np
import pytest

from jarvis_hybridnet_torch import native as port
from jarvis_hybridnet_tpu import native as ref

cv2 = pytest.importorskip("cv2")

W, H, CAMS, ITEMS = 96, 64, 3, 5


@pytest.fixture(scope="module")
def jpegs(tmp_path_factory):
    """ITEMS framesets of CAMS seeded JPEGs of W x H, and one of 40 x 30."""
    if not ref.available():
        pytest.skip("the JAX package's native JPEG library does not build here")
    assert port.available(), "the JAX package's library builds here, the port's does not"
    root = tmp_path_factory.mktemp("jpegs")
    rng = np.random.default_rng(0)
    framesets = []
    for i in range(ITEMS):
        paths = []
        for c in range(CAMS):
            img = cv2.resize(rng.integers(0, 256, (H // 8, W // 8, 3), dtype=np.uint8), (W, H))
            img = np.clip(img.astype(np.int16) + rng.integers(-9, 10, img.shape), 0, 255)
            path = str(root / f"f{i}_c{c}.jpg")
            cv2.imwrite(path, img.astype(np.uint8))
            paths.append(path)
        framesets.append(paths)
    odd = str(root / "odd.jpg")
    cv2.imwrite(odd, rng.integers(0, 256, (30, 40, 3), dtype=np.uint8))
    return framesets, odd


def test_probe_and_decode_jpeg_bit_equal(jpegs):
    framesets, odd = jpegs
    for path in [p for fs in framesets for p in fs] + [odd]:
        assert port.probe_jpeg(path) == ref.probe_jpeg(path)
        got, want = port.decode_jpeg(path), ref.decode_jpeg(path)
        assert got.dtype == np.uint8 and got.shape == want.shape
        np.testing.assert_array_equal(got, want)
    assert port.probe_jpeg(odd) == (40, 30)
    assert port.decode_jpeg(odd + ".missing") is None


@pytest.mark.parametrize("threads", [1, 3])
def test_decode_batch_bit_equal(jpegs, threads):
    framesets, odd = jpegs
    paths = [p for fs in framesets for p in fs]
    got = port.decode_batch(paths, W, H, num_threads=threads)
    np.testing.assert_array_equal(got, ref.decode_batch(paths, W, H, num_threads=threads))
    assert got.shape == (len(paths), H, W, 3)
    # a frame of another size fails the batch in both
    assert port.decode_batch(paths[:2] + [odd], W, H) is None
    assert ref.decode_batch(paths[:2] + [odd], W, H) is None


def test_decode_crop_batch_bit_equal(jpegs):
    framesets, _ = jpegs
    paths = framesets[0]
    centers = np.array([[10, 10], [48, 32], [90, 60]], np.int32)  # clamped at the edges
    got = port.decode_crop_batch(paths, centers, 32, W, H)
    np.testing.assert_array_equal(got, ref.decode_crop_batch(paths, centers, 32, W, H))
    assert got.shape == (CAMS, 32, 32, 3)


@pytest.mark.parametrize("bbox", [0, 32])
def test_frameset_pipeline_bit_equal(jpegs, bbox):
    framesets, _ = jpegs
    centers = None
    if bbox:
        rng = np.random.default_rng(1)
        centers = np.stack([rng.integers(0, W, (ITEMS, CAMS)),
                            rng.integers(0, H, (ITEMS, CAMS))], axis=-1).astype(np.int32)
    runs = []
    for mod in (port, ref):
        pipe = mod.FramesetPipeline(framesets, W, H, centers=centers, bbox=bbox,
                                    num_threads=2, prefetch=2)
        runs.append([(idx, out.copy()) for idx, out in pipe])
        pipe.close()
    got, want = runs
    assert [i for i, _ in got] == [i for i, _ in want] == list(range(ITEMS))
    for (_, a), (_, b) in zip(got, want):
        side = (bbox, bbox) if bbox else (H, W)
        assert a.shape == (CAMS, *side, 3)
        np.testing.assert_array_equal(a, b)
    if not bbox:  # full frames are the batch decode of each frameset
        np.testing.assert_array_equal(got[2][1], port.decode_batch(framesets[2], W, H))


def test_frameset_pipeline_raises_on_a_missing_file(jpegs):
    framesets, _ = jpegs
    broken = [list(fs) for fs in framesets[:2]]
    broken[1][1] += ".missing"
    for mod in (port, ref):
        pipe = mod.FramesetPipeline(broken, W, H, num_threads=1)
        with pytest.raises(RuntimeError, match="frameset 1"):
            list(pipe)
        pipe.close()
