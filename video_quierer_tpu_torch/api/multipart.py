"""``multipart/form-data`` bodies on the standard library (RFC 7578): the
parts of a request body, each with its headers, form name, file name and
bytes, untouched (binary parts included).

- :class:`MultipartReader` reads the body from a ``read(n)`` callable and
  hands the parts over in order, each one's bytes in chunks
  (``StreamPart.read_chunk``): the video upload streams its file part to
  disk and never holds the body in memory;
- :func:`parse_multipart` parses a body held in memory (the image search
  and the cache import) through the same reader.
"""

from __future__ import annotations

import dataclasses
import io
from email.message import Message
from email.utils import collapse_rfc2231_value
from typing import Callable, Dict, List, Optional

# a part's header block larger than this is refused
MAX_HEADER_BYTES = 64 * 1024
_FILL = 1 << 20


@dataclasses.dataclass
class Part:
    name: Optional[str]
    filename: Optional[str]
    headers: Dict[str, str]
    data: bytes

    def text(self) -> str:
        return self.data.decode("utf-8")


def _header_params(value: str) -> Message:
    """A header value with parameters, parsed (quoting and RFC 2231
    included) by ``email.message.Message``."""
    msg = Message()
    msg["content-type"] = value
    return msg


def _param(msg: Message, key: str) -> Optional[str]:
    value = msg.get_param(key)
    return None if value is None else collapse_rfc2231_value(value)


class StreamPart:
    """One part of a :class:`MultipartReader`'s body: its headers, form
    name and file name; its bytes read in chunks."""

    def __init__(self, reader: "MultipartReader", headers: Dict[str, str]):
        self._reader = reader
        self.headers = headers
        disp = _header_params(
            "form-data; " + headers.get("content-disposition", "")
            .partition(";")[2])
        self.name = _param(disp, "name")
        self.filename = _param(disp, "filename")
        self.done = False

    def read_chunk(self, size: int = _FILL) -> bytes:
        """Up to ``size`` more bytes of the part; ``b""`` at its end."""
        if self.done:
            return b""
        r = self._reader
        while True:
            end = r._buf.find(r._delim)
            if end == 0:
                self.done = True
                return b""
            if end < 0:
                # the bytes that cannot begin a delimiter are the part's
                end = len(r._buf) - len(r._delim) + 1
                if end < size and r._fill():
                    continue
                if end <= 0:
                    raise ValueError(
                        "multipart body without a closing delimiter")
            out = r._buf[:min(end, size)]
            r._buf = r._buf[len(out):]
            return out

    def read(self) -> bytes:
        """The rest of the part."""
        out = []
        while True:
            chunk = self.read_chunk()
            if not chunk:
                return b"".join(out)
            out.append(chunk)

    def text(self) -> str:
        return self.read().decode("utf-8")


class MultipartReader:
    """The parts of a ``multipart/form-data`` body read by ``read(n)``, in
    order (:meth:`next`). Raises ``ValueError`` when the content type is
    not multipart or carries no boundary, or the body is malformed or has
    no closing delimiter."""

    def __init__(self, read: Callable[[int], bytes], content_type: str):
        ctype = _header_params(content_type or "")
        if ctype.get_content_maintype() != "multipart":
            raise ValueError(f"not a multipart body: {content_type!r}")
        boundary = ctype.get_param("boundary")
        if not boundary:
            raise ValueError("multipart body without a boundary")
        self._read = read
        # every delimiter follows a CRLF, the first one included once the
        # body is prefixed with one; what precedes it is the preamble
        self._delim = b"\r\n--" + str(boundary).encode("latin-1")
        self._buf = b"\r\n"
        self._eof = False
        self._done = False
        self._part: Optional[StreamPart] = None

    def _fill(self) -> bool:
        if self._eof:
            return False
        data = self._read(_FILL)
        if not data:
            self._eof = True
            return False
        self._buf += data
        return True

    def _until(self, sep: bytes, what: str,
               limit: Optional[int] = None) -> int:
        """The offset of ``sep`` in the buffer, reading until it is there."""
        while True:
            i = self._buf.find(sep)
            if i >= 0:
                return i
            if limit is not None and len(self._buf) > limit:
                raise ValueError(f"multipart {what} too long")
            if not self._fill():
                raise ValueError(f"multipart body without {what}")

    def _at_least(self, n: int) -> None:
        while len(self._buf) < n and self._fill():
            pass

    def next(self) -> Optional[StreamPart]:
        """The next part (the rest of the current one is skipped); None
        after the closing delimiter."""
        if self._part is not None:
            while self._part.read_chunk():
                pass
        if self._done:
            return None
        while self._buf.find(self._delim) < 0:     # skip the preamble
            keep = len(self._delim) - 1
            if len(self._buf) > keep:
                self._buf = self._buf[-keep:]
            if not self._fill():
                raise ValueError(
                    "multipart body without a closing delimiter")
        self._buf = self._buf[self._buf.find(self._delim)
                              + len(self._delim):]
        self._at_least(2)
        if self._buf.startswith(b"--"):
            self._done = True
            self._part = None
            return None
        # transport padding up to the CRLF that ends the delimiter line
        eol = self._until(b"\r\n", "delimiter line end", MAX_HEADER_BYTES)
        if self._buf[:eol].strip(b" \t"):
            raise ValueError("malformed multipart delimiter line")
        self._buf = self._buf[eol + 2:]
        self._at_least(2)
        if self._buf.startswith(b"\r\n"):          # a part without headers
            head = b""
            self._buf = self._buf[2:]
        else:
            end = self._until(b"\r\n\r\n", "part header block",
                              MAX_HEADER_BYTES)
            head = self._buf[:end]
            self._buf = self._buf[end + 4:]
        headers: Dict[str, str] = {}
        for line in head.decode("latin-1").split("\r\n"):
            if line:
                key, _, value = line.partition(":")
                headers[key.strip().lower()] = value.strip()
        self._part = StreamPart(self, headers)
        return self._part

    def __iter__(self):
        while True:
            part = self.next()
            if part is None:
                return
            yield part


def parse_multipart(body: bytes, content_type: str) -> List[Part]:
    """The parts of a ``multipart/form-data`` body held in memory, in
    order (:class:`MultipartReader`'s rules and errors)."""
    reader = MultipartReader(io.BytesIO(body).read, content_type)
    return [Part(p.name, p.filename, p.headers, p.read()) for p in reader]
