"""The port's msgpack reader (``utils/flax_msgpack.py``, no third-party
import) against ``flax.serialization.msgpack_restore``: every NICE
checkpoint under data/ and the JAX-trained MNIST EBM parameters decode to
the same tree with the same arrays bit for bit, and a blob made with the
``msgpack`` package covering every type the reader takes decodes to what
msgpack itself decodes."""
from pathlib import Path

import msgpack
import numpy as np
import pytest
from flax import serialization

from sde_sampler_lrds_torch.utils import flax_msgpack

REPO = Path(__file__).parents[1]
FILES = ([REPO / "data" / f"nice_label_{d}.msgpack" for d in range(10)]
         + [REPO / "experiments" / "results_mnist" / "ebm_params_mnist_zero_one_seed_0.msgpack"])


def _assert_same_tree(got, want, where="root"):
    assert type(got) is type(want) or (isinstance(got, np.ndarray)
                                       and isinstance(want, np.ndarray)), where
    if isinstance(want, dict):
        assert list(got) == list(want), where
        for k in want:
            _assert_same_tree(got[k], want[k], f"{where}/{k}")
    elif isinstance(want, (list, tuple)):
        assert len(got) == len(want), where
        for i, (g, w) in enumerate(zip(got, want)):
            _assert_same_tree(g, w, f"{where}[{i}]")
    elif isinstance(want, np.ndarray):
        assert got.dtype == want.dtype and got.shape == want.shape, where
        assert got.tobytes() == want.tobytes(), where
    else:
        assert got == want, where


@pytest.mark.parametrize("path", FILES, ids=[p.stem for p in FILES])
def test_checkpoints_decode_as_flax_does(path):
    blob = path.read_bytes()
    _assert_same_tree(flax_msgpack.msgpack_restore(blob), serialization.msgpack_restore(blob))


def test_every_type_the_reader_takes():
    tree = {
        "ints": [0, 127, -1, -32, -33, -128, -129, -32768, -32769, -2**31 - 1, -2**63,
                 128, 255, 256, 65535, 65536, 2**32 - 1, 2**32, 2**64 - 1],
        "floats": [0.5, -1e300, float("inf")], "nil": None, "bools": [True, False],
        "strs": ["", "a" * 31, "b" * 32, "c" * 300, "d" * 70000, "ü"],
        "bins": [b"", b"x" * 255, b"y" * 256, b"z" * 70000],
        "long": list(range(20)), "wide": {f"k{i}": i for i in range(20)},
    }
    blob = msgpack.packb(tree, use_bin_type=True)
    assert flax_msgpack.msgpack_restore(blob) == msgpack.unpackb(blob, raw=False)
    single = msgpack.packb(np.float32(1.25).item(), use_single_float=True)
    assert single[0] == 0xCA and flax_msgpack.msgpack_restore(single) == 1.25
    # Flax's numpy extension types: arrays of several dtypes and ranks
    # (fixext and ext 8 / 16 / 32 payload sizes), and numpy scalars
    rng = np.random.default_rng(0)
    arrays = {"f32": rng.normal(size=(3, 4)).astype(np.float32), "scalar0d": np.float64(2.5),
              "i8": np.arange(-4, 4, dtype=np.int8), "big": rng.normal(size=(70, 300)),
              "u16": np.arange(7, dtype=np.uint16).reshape(7, 1, 1), "b": np.array([True])}
    blob = serialization.msgpack_serialize(arrays)
    _assert_same_tree(flax_msgpack.msgpack_restore(blob), serialization.msgpack_restore(blob))


def test_malformed_blobs_are_refused():
    blob = msgpack.packb({"a": [1, 2, 3]})
    with pytest.raises(ValueError, match="truncated"):
        flax_msgpack.msgpack_restore(blob[:-1])
    with pytest.raises(ValueError, match="trailing"):
        flax_msgpack.msgpack_restore(blob + b"\x00")
    with pytest.raises(ValueError, match="unknown type byte"):
        flax_msgpack.msgpack_restore(b"\xc1")
    with pytest.raises(ValueError, match="extension type 2"):
        flax_msgpack.msgpack_restore(b"\xd4\x02\x00")
    chunked = msgpack.packb({"__msgpack_chunked_array__": True, "chunks": []})
    with pytest.raises(ValueError, match="chunked"):
        flax_msgpack.msgpack_restore(chunked)
