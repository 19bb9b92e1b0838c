"""The port's streaming multipart reader (``api/multipart.py``): the same
parts, names, file names, headers and bytes whatever sizes the body
arrives in (1, 7, 64 and 4,096 bytes a read, so that delimiters and
header blocks straddle reads), binary data holding near-delimiters
included; a file part handed over in chunks of at most the asked size;
a part left unread skipped by the next; and the buffered
``parse_multipart`` on the same bodies. Malformed bodies raise
``ValueError`` at any read size."""

import io

import numpy as np
import pytest

from video_quierer_tpu_torch.api.multipart import (
    MultipartReader,
    parse_multipart,
)

B = "vqt-b0undary"
CT = f"multipart/form-data; boundary={B}"


def body_of(parts, preamble=b"", epilogue=b""):
    out = preamble
    for head, data in parts:
        out += f"--{B}\r\n".encode() + head + b"\r\n" + data + b"\r\n"
    return out + f"--{B}--\r\n".encode() + epilogue


def _file_bytes():
    rng = np.random.default_rng(4)
    data = rng.integers(0, 256, 20_000, dtype=np.uint8).tobytes()
    # near-delimiters: a CRLF and dashes, a partial boundary
    return data[:5000] + f"\r\n--{B[:-1]}x".encode() + data[5000:] + \
        b"\r\n-" + b"\r\n--" + B.encode()[:5]


PARTS = [
    (b'Content-Disposition: form-data; name="video_id"\r\n', b"abc"),
    (b'Content-Disposition: form-data; name="file"; '
     b'filename="a b.mp4"\r\nContent-Type: video/mp4\r\n', _file_bytes()),
    (b'Content-Disposition: form-data; name="empty"\r\n', b""),
    (b"", b"no headers at all"),
    (b"Content-Disposition: form-data; name*=UTF-8''caf%C3%A9\r\n", b"x"),
]


def chunked_reader(data: bytes, step: int):
    buf = io.BytesIO(data)
    return lambda n: buf.read(min(n, step))


@pytest.mark.parametrize("step", [1, 7, 64, 4096])
def test_stream_reader_matches_the_buffered_parser(step):
    body = body_of(PARTS, preamble=b"ignored preamble\r\n",
                   epilogue=b"trailing")
    want = parse_multipart(body, CT)
    assert [p.data for p in want] == [d for _, d in PARTS]
    reader = MultipartReader(chunked_reader(body, step), CT)
    got = []
    for part in reader:
        chunks = []
        while True:
            chunk = part.read_chunk(1000)
            if not chunk:
                break
            assert len(chunk) <= 1000
            chunks.append(chunk)
        got.append((part.name, part.filename, part.headers, b"".join(chunks)))
    assert got == [(p.name, p.filename, p.headers, p.data) for p in want]
    assert [g[0] for g in got] == ["video_id", "file", "empty", None,
                                   "café"]
    assert got[1][1] == "a b.mp4"


@pytest.mark.parametrize("step", [1, 13, 4096])
def test_unread_parts_are_skipped(step):
    body = body_of(PARTS)
    reader = MultipartReader(chunked_reader(body, step), CT)
    first = reader.next()
    assert first.name == "video_id"
    second = reader.next()
    assert second.read_chunk(10) == PARTS[1][1][:10]
    third = reader.next()                      # the file's rest skipped
    assert third.name == "empty" and third.read() == b""
    assert reader.next().text() == "no headers at all"
    assert reader.next().name == "café"
    assert reader.next() is None and reader.next() is None


BAD = {
    "not multipart": (b"", "application/json"),
    "no boundary": (b"", "multipart/form-data"),
    "no closing delimiter": (body_of(PARTS)[:-8], CT),
    "no delimiter": (b"just bytes", CT),
    "junk after delimiter": (f"--{B} junk\r\n\r\nx\r\n--{B}--".encode(), CT),
    "no header end": (f"--{B}\r\nContent-Disposition: x".encode(), CT),
}


@pytest.mark.parametrize("step", [1, 4096])
@pytest.mark.parametrize("case", list(BAD))
def test_malformed_bodies_raise(case, step):
    body, ctype = BAD[case]
    with pytest.raises(ValueError):
        for part in MultipartReader(chunked_reader(body, step), ctype):
            part.read()
    with pytest.raises(ValueError):
        parse_multipart(body, ctype)
