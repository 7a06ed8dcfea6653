"""Fabricate *python-2-written* pickles from python 3 — the real-dataset
dry dock.

Port of ``mrgan_tpu/data/py2pickle.py``, copied line for line (pure
python): the same object gives the same bytes.

The distributed MREO dataset (reference README.md:8-10) was pickled by
python 2.7: its streams carry py2 ``str`` objects (SHORT_BINSTRING /
BINSTRING opcodes) for dict keys, numpy dtype descriptors, and raw array
buffers, and reference ``numpy.core.multiarray`` by its py2-era module path.
A py3 ``pickle.dumps(protocol=2)`` stream does NOT exercise any of that —
py3 str pickles as BINUNICODE and bytes reconstruct through
``_codecs.encode`` — so tests written against py3 streams prove nothing
about the real files. This module emits the py2 byte stream shape from py3:

- every ``str`` and ``bytes`` is written as SHORT_BINSTRING/BINSTRING
  (py2 ``str``), exactly what ``pickle.load(..., encoding='latin1')`` has to
  decode on the real dataset (the loaders' contract, mreo.py:46-60);
- globals from renamed-in-py3 numpy modules are written with their py2
  module paths (``numpy._core.multiarray`` -> ``numpy.core.multiarray``),
  matching what a py2 numpy pickle contains; numpy's own unpickling shims
  resolve them on load;
- protocol 2 — py2's highest — with ``fix_imports`` handling of the stdlib
  renames (``copyreg`` -> ``copy_reg``) the standard pickler already does.

Fidelity is pinned by the dry-dock tests: the streams contain
BINSTRING opcodes and no BINUNICODE, the py2 numpy module paths, fail to
load under py3's default ASCII decode (like the real files), and round-trip
bitwise under ``encoding='latin1'`` through the production loaders.
"""

import io
import pickle
import struct

# py3 module -> the path a python-2 pickler would have written. numpy
# renamed numpy.core to numpy._core in 2.x but ships loader aliases for the
# old path, so streams written with the OLD name load under both eras.
_PY2_MODULE_NAMES = {
    "numpy._core.multiarray": "numpy.core.multiarray",
    "numpy._core.numeric": "numpy.core.numeric",
    "numpy._core.umath": "numpy.core.umath",
    "numpy._core": "numpy.core",
}


class Py2Pickler(pickle._Pickler):
    """Protocol-2 pickler emitting python-2.7-shaped streams.

    Uses the pure-python pickler so the str/bytes/global dispatch can be
    overridden at the opcode level.
    """

    dispatch = pickle._Pickler.dispatch.copy()

    def __init__(self, file):
        super().__init__(file, protocol=2, fix_imports=True)

    def _write_binstring(self, data):
        n = len(data)
        if n < 256:
            self.write(b"U" + struct.pack("<B", n) + data)  # SHORT_BINSTRING
        else:
            self.write(b"T" + struct.pack("<i", n) + data)  # BINSTRING

    def save_str_as_py2(self, obj):
        try:
            data = obj.encode("latin1")
        except UnicodeEncodeError:
            raise ValueError(
                "py2 str streams are byte strings; %r is not latin1-"
                "representable" % (obj[:40],)
            )
        self._write_binstring(data)
        self.memoize(obj)

    def save_bytes_as_py2(self, obj):
        # py2 had no bytes/str split: raw buffers (numpy array data) were
        # str, i.e. BINSTRING opcodes
        self._write_binstring(obj)
        self.memoize(obj)

    dispatch[str] = save_str_as_py2
    dispatch[bytes] = save_bytes_as_py2

    def save_global(self, obj, name=None):
        module = getattr(obj, "__module__", None)
        mapped = _PY2_MODULE_NAMES.get(module)
        if mapped is not None:
            qual = name or getattr(obj, "__qualname__", obj.__name__)
            self.write(
                b"c" + mapped.encode("ascii") + b"\n"  # GLOBAL
                + qual.encode("ascii") + b"\n"
            )
            self.memoize(obj)
            return
        super().save_global(obj, name)


def dumps_py2(obj):
    buf = io.BytesIO()
    Py2Pickler(buf).dump(obj)
    return buf.getvalue()


def dump_py2(obj, path):
    with open(path, "wb") as f:
        Py2Pickler(f).dump(obj)
