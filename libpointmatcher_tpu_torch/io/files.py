"""What the loaders and savers share: reading a source and opening a
destination, each a path or a file object."""

from __future__ import annotations

from typing import BinaryIO, TextIO, Union

__all__ = ["read_bytes", "open_dest"]


def read_bytes(source: Union[str, BinaryIO, TextIO]) -> bytes:
    """The whole content of a path or a readable file object, as bytes."""
    if hasattr(source, "read"):
        data = source.read()
        return data.encode() if isinstance(data, str) else data
    with open(source, "rb") as f:
        return f.read()


def open_dest(dest, text: bool = False):
    """``(file, owned)``: ``dest`` itself if it is writable, else the path
    opened for writing (text mode with no newline translation, or binary)."""
    if hasattr(dest, "write"):
        return dest, False
    return (open(dest, "w", newline="") if text else open(dest, "wb")), True

