"""``multipart/form-data`` bodies on the standard library (RFC 7578): the
parts of a request body, each with its headers, form name, file name and
bytes, untouched (binary parts included)."""

from __future__ import annotations

import dataclasses
from email.message import Message
from email.utils import collapse_rfc2231_value
from typing import Dict, List, Optional


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


def parse_multipart(body: bytes, content_type: str) -> List[Part]:
    """The parts of a ``multipart/form-data`` body, in order. Raises
    ``ValueError`` when the content type is not multipart, carries no
    boundary, or the body has no closing delimiter."""
    ctype = _header_params(content_type or "")
    if ctype.get_content_maintype() != "multipart":
        raise ValueError(f"not a multipart body: {content_type!r}")
    boundary = ctype.get_param("boundary")
    if not boundary:
        raise ValueError("multipart body without a boundary")
    delim = b"\r\n--" + str(boundary).encode("latin-1")
    # every delimiter follows a CRLF, the first one included once the
    # body is prefixed with one; what precedes it is the preamble
    chunks = (b"\r\n" + body).split(delim)
    parts: List[Part] = []
    for chunk in chunks[1:]:
        if chunk.startswith(b"--"):
            return parts
        # transport padding up to the CRLF that ends the delimiter line
        eol = chunk.find(b"\r\n")
        if eol < 0 or chunk[:eol].strip(b" \t"):
            raise ValueError("malformed multipart delimiter line")
        rest = chunk[eol + 2:]
        if rest.startswith(b"\r\n"):        # a part without headers
            head, data = b"", rest[2:]
        else:
            head, sep, data = rest.partition(b"\r\n\r\n")
            if not sep:
                raise ValueError("multipart part without a header block")
        headers: Dict[str, str] = {}
        for line in head.decode("latin-1").split("\r\n"):
            if line:
                key, _, value = line.partition(":")
                headers[key.strip().lower()] = value.strip()
        disp = _header_params(
            "form-data; " + headers.get("content-disposition", "")
            .partition(";")[2])
        name, filename = disp.get_param("name"), disp.get_param("filename")
        parts.append(Part(
            name=None if name is None else collapse_rfc2231_value(name),
            filename=(None if filename is None
                      else collapse_rfc2231_value(filename)),
            headers=headers, data=data))
    raise ValueError("multipart body without a closing delimiter")
