"""The port's zstd decoders (elasticdl_tpu_torch/common/zstd.py, the
Python one, and hostsrc/zstd_decode.cc, built with g++) against the
`zstandard` package on the CPU: random compressible byte strings at
levels -5, 1, 3 and 19, with and without the content checksum and the
content size, in one or more frames with skippable frames between them,
decode to the same bytes in both; a corrupt frame raises or, where the
flip does not change what the frame holds, decodes to the same bytes (a
flip in the window descriptor can widen the window and change nothing),
and never to other bytes; a truncated frame raises; a frame that names a
dictionary raises."""

import io

import numpy as np
import pytest
import zstandard
from hypothesis import given, settings
from hypothesis import strategies as st

from elasticdl_tpu_torch.common import zstd

SETTINGS = settings(max_examples=40, deadline=None, derandomize=True,
                    database=None)
LEVELS = (-5, 1, 3, 19)


def _payload(seed: int, size: int, kind: int) -> bytes:
    """Compressible bytes of a few shapes: runs, a small alphabet,
    float32 noise, a repeated phrase with edits, random bytes."""
    rng = np.random.RandomState(seed)
    if kind == 0:
        return bytes(np.repeat(rng.randint(0, 256, size // 16 + 1),
                               16)[:size].astype(np.uint8))
    if kind == 1:
        return bytes(rng.randint(0, 5, size).astype(np.uint8))
    if kind == 2:
        return rng.randn(size // 4).astype(np.float32).tobytes()
    if kind == 3:
        out = bytearray(b"the quick brown fox jumps over " * (size // 31 + 1))
        for i in rng.randint(0, len(out), max(1, size // 50)):
            out[i] = rng.randint(0, 256)
        return bytes(out[:size])
    return rng.bytes(size)


payloads = st.builds(_payload, st.integers(0, 2 ** 31 - 1),
                     st.integers(0, 70000), st.integers(0, 4))
frame_options = st.fixed_dictionaries({
    "level": st.sampled_from(LEVELS),
    "checksum": st.booleans(),
    "content_size": st.booleans(),
})


def _frame(data: bytes, opts) -> bytes:
    return zstandard.ZstdCompressor(
        level=opts["level"], write_checksum=opts["checksum"],
        write_content_size=opts["content_size"]).compress(data)


def _skippable(n: int) -> bytes:
    return (0x184D2A5E).to_bytes(4, "little") + n.to_bytes(4, "little") \
        + b"\x07" * n


def _reference(blob: bytes) -> bytes:
    """`zstandard`'s decoding of every frame of `blob`."""
    return zstandard.ZstdDecompressor().stream_reader(
        io.BytesIO(blob), read_across_frames=True).read()


@pytest.fixture(scope="module", autouse=True)
def native():
    assert zstd.native_available(), zstd.unavailable_reason


def _both(blob: bytes):
    """(Python's result or its error, the C++ result or its error)."""
    out = []
    for decode in (zstd.decompress_py, zstd.decompress_native):
        try:
            out.append(decode(blob))
        except zstd.ZstdError as exc:
            out.append(exc)
    return out


@SETTINGS
@given(data=payloads, opts=frame_options)
def test_one_frame_decodes_as_zstandard_does(data, opts):
    blob = _frame(data, opts)
    want = _reference(blob)
    assert want == data
    assert zstd.decompress_py(blob) == want
    assert zstd.decompress_native(blob) == want


@SETTINGS
@given(parts=st.lists(st.tuples(payloads, frame_options), min_size=2,
                      max_size=3),
       skip=st.integers(0, 40))
def test_concatenated_and_skippable_frames_decode_as_zstandard_does(
        parts, skip):
    blob = _skippable(skip).join(_frame(d, o) for d, o in parts)
    want = _reference(blob)
    assert want == b"".join(d for d, _ in parts)
    zstd.reset_served()
    assert zstd.decompress_py(blob) == want
    assert zstd.decompress_native(blob) == want
    assert zstd.served() == {"native": len(parts), "python": len(parts)}
    assert zstd.decompress(blob) == want
    assert zstd.served()["native"] == 2 * len(parts)


@SETTINGS
@given(data=payloads, level=st.sampled_from(LEVELS),
       where=st.floats(0, 1, exclude_max=True), bit=st.integers(0, 7))
def test_a_corrupt_frame_raises_or_decodes_to_its_own_bytes(
        data, level, where, bit):
    blob = bytearray(_frame(data, {"level": level, "checksum": True,
                                   "content_size": True}))
    blob[int(where * len(blob))] ^= 1 << bit
    py, native = _both(bytes(blob))
    for got in (py, native):
        assert isinstance(got, zstd.ZstdError) or got == data
    assert type(py) is type(native)


@SETTINGS
@given(data=payloads, opts=frame_options,
       keep=st.floats(0, 1, exclude_max=True))
def test_a_truncated_frame_raises(data, opts, keep):
    blob = _frame(data, opts)
    py, native = _both(blob[:int(keep * len(blob))])
    assert isinstance(py, zstd.ZstdError)
    assert isinstance(native, zstd.ZstdError)


def test_literal_and_sequence_modes_are_all_reached():
    """Inputs that force each path the hypothesis cases reach by chance:
    RLE blocks, raw blocks of incompressible bytes, one and four
    Huffman streams, repeated (treeless) Huffman tables and repeat-mode
    sequence tables over many blocks, and a long-distance match."""
    rng = np.random.RandomState(1)
    cases = [b"\x00" * 500000, rng.bytes(300000),
             b"ab" * 20 + rng.bytes(10),
             bytes(rng.randint(0, 3, 600000).astype(np.uint8)),
             rng.bytes(200000) * 3]
    for data in cases:
        for level in LEVELS:
            blob = _frame(data, {"level": level, "checksum": True,
                                 "content_size": False})
            assert zstd.decompress_native(blob) == data
    # the Python decoder on the shorter ones (it runs at ~1 MB/s)
    for data in cases[:3]:
        blob = _frame(data, {"level": 3, "checksum": True,
                             "content_size": True})
        assert zstd.decompress_py(blob) == data


def test_a_frame_that_names_a_dictionary_raises():
    samples = [bytes(f"record {i} of the training set {i * 7}", "ascii")
               for i in range(400)]
    dictionary = zstandard.train_dictionary(1024, samples)
    blob = zstandard.ZstdCompressor(dict_data=dictionary).compress(
        samples[3])
    for decode in (zstd.decompress_py, zstd.decompress_native):
        with pytest.raises(zstd.ZstdError, match="dictionar"):
            decode(blob)


def test_not_a_frame_and_empty_input_raise():
    for blob in (b"", b"\x00\x01\x02\x03\x04", _skippable(3)):
        for decode in (zstd.decompress_py, zstd.decompress_native):
            with pytest.raises(zstd.ZstdError):
                decode(blob)


def test_xxh64_matches_the_reference_values():
    # the published XXH64 test vectors (seed 0)
    assert zstd.xxh64(b"") == 0xEF46DB3751D8E999
    assert zstd.xxh64(b"a") == 0xD24EC4F1A98C6E5B
    assert zstd.xxh64(b"abc") == 0x44BC2CF5AD770999
    data = bytes(range(256)) * 3
    blob = zstandard.ZstdCompressor(write_checksum=True).compress(data)
    assert int.from_bytes(blob[-4:], "little") == \
        zstd.xxh64(data) & 0xFFFFFFFF
