"""Native IO library vs pure-Python implementations (byte-identical)."""

import os

import numpy as np
import pytest

from paris_tpu.io import native
from paris_tpu.io.his import read_his, write_his, HisFormatError
from paris_tpu.io import ddbvf

@pytest.fixture(autouse=True)
def _need_native_library():
    # decided per test (building the library at first use), not at import
    if not native.available():
        pytest.skip("native I/O library did not build (no C++ compiler?)")


@pytest.mark.parametrize("dtype", [np.uint8, np.uint16, np.uint32,
                                   np.float32, np.float64])
def test_native_his_matches_python(tmp_path, dtype):
    rng = np.random.default_rng(5)
    frames = rng.uniform(0, 250, (4, 33, 57)).astype(dtype)
    p = str(tmp_path / "n.his")
    write_his(p, frames, number_dtype=dtype)

    nat = native.his_read(p)
    os.environ["PARIS_IO_NO_NATIVE"] = "1"
    try:
        py = read_his(p)
    finally:
        del os.environ["PARIS_IO_NO_NATIVE"]
    np.testing.assert_array_equal(nat, py)


def test_native_his_rejects_garbage(tmp_path):
    p = str(tmp_path / "junk.his")
    with open(p, "wb") as f:
        f.write(b"\x01" * 100)
    with pytest.raises(native.NativeIoError):
        native.his_read(p)
    # and through the high-level reader -> HisFormatError (skippable)
    with pytest.raises(HisFormatError):
        read_his(p)


def test_native_ddbvf_roundtrip(tmp_path):
    p = str(tmp_path / "n.ddbvf")
    native.ddbvf_create(p, 7, 5, 6)
    assert native.ddbvf_open(p) == (7, 5, 6)
    assert ddbvf.open_meta(p) == (7, 5, 6)       # python reader agrees
    rng = np.random.default_rng(6)
    vol = rng.standard_normal((6, 5, 7)).astype(np.float32)
    native.ddbvf_write(p, vol[:3], 0)
    native.ddbvf_write(p, vol[3:], 3)
    np.testing.assert_array_equal(native.ddbvf_read(p, 0, 6), vol)
    np.testing.assert_array_equal(ddbvf.read_volume(p), vol)  # python agrees


def test_native_ddbvf_bounds(tmp_path):
    p = str(tmp_path / "b.ddbvf")
    native.ddbvf_create(p, 4, 4, 4)
    with pytest.raises(native.NativeIoError):
        native.ddbvf_write(p, np.zeros((3, 4, 4), np.float32), 2)


def test_python_written_file_native_read(tmp_path):
    p = str(tmp_path / "x.ddbvf")
    ddbvf.create(p, 3, 4, 5)
    rng = np.random.default_rng(7)
    vol = rng.standard_normal((5, 4, 3)).astype(np.float32)
    os.environ["PARIS_IO_NO_NATIVE"] = "1"
    try:
        ddbvf.write_slices(p, vol, 0)
    finally:
        del os.environ["PARIS_IO_NO_NATIVE"]
    np.testing.assert_array_equal(native.ddbvf_read(p, 0, 5), vol)
