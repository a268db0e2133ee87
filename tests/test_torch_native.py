"""The port's native batch packer (``genrec_tpu_torch/native/packer.cpp`` and
``data/native_packer.py``) against its Python path and the JAX package's
two paths.

The packer is built with ``g++`` into a temporary build directory, from
the port's own source and never with ``-march=native``; it never loads the
JAX tree's library. On ``tests/test_native.py``'s three cases its arrays are
bit-equal to the port's Python builders and to the JAX package's Python and
native builders. Without ``g++`` it is not available and the builders take
their Python paths; a failed compile raises.
"""

import os

import numpy as np
import pytest

from genrec_tpu.data import datasets as jdatasets
from genrec_tpu.data import native_packer as jnative
from genrec_tpu_torch.data import datasets, native_packer, synthetic, tiger_tokens


@pytest.fixture(scope="module")
def built(tmp_path_factory):
    """The packer built once into a fresh temporary build directory."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(native_packer, "BUILD_DIR", str(tmp_path_factory.mktemp("native") / "_build"))
        assert native_packer.available()
        yield native_packer.library_path()


@pytest.fixture(scope="module")
def corpus():
    return synthetic.make_interactions(num_users=400, num_items=90, min_len=2,
                                       max_len=30, seed=3)


def _equal(got, others):
    for want in others:
        assert got.keys() == want.keys()
        for k in got:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def _jax_native():
    """The JAX package's native path, where its library loads."""
    return (True,) if jnative.available() else ()


def test_built_from_the_port_source_without_march_native(built):
    assert os.path.dirname(built) == native_packer.BUILD_DIR
    assert os.path.basename(built).startswith("libgenrec_native-")
    assert "-march=native" not in native_packer.CXX_FLAGS
    assert native_packer.SOURCE.endswith(os.path.join("genrec_tpu_torch", "native", "packer.cpp"))
    lib = native_packer._lib()
    assert os.path.realpath(lib._name) == os.path.realpath(built)
    assert lib.genrec_native_abi_version() == native_packer.ABI_VERSION == 1


@pytest.mark.parametrize("mode", ["train", "test"])
def test_sasrec_pack_matches_python_and_jax(built, corpus, mode):
    got = datasets.build_sasrec_arrays(corpus, max_len=12, mode=mode, min_seq_len=3,
                                       use_native=True)
    others = [datasets.build_sasrec_arrays(corpus, 12, mode, 3, use_native=False)]
    others += [jdatasets.build_sasrec_arrays(corpus, 12, mode, 3, use_native=n)
               for n in (False, *_jax_native())]
    _equal(got.arrays, [o.arrays for o in others])
    assert got.item_num == others[0].item_num


def test_tiger_pack_matches_python_and_jax(built, corpus):
    codes = synthetic.make_codes(90, seed=1)
    train, test = tiger_tokens.build_tiger_splits(corpus.item_id_lists, corpus.user_ids, codes)
    for split, mt in ((train, None), (test, 1)):
        got = datasets.build_tiger_arrays(split, max_len=10, max_target_items=mt,
                                          use_native=True)
        others = [datasets.build_tiger_arrays(split, 10, max_target_items=mt, use_native=False)]
        others += [jdatasets.build_tiger_arrays(split, 10, max_target_items=mt, use_native=n)
                   for n in (False, *_jax_native())]
        _equal(got.arrays, [o.arrays for o in others])


def test_dense_t5_pack_matches_python_and_jax(built, corpus):
    got = datasets.build_dense_t5_arrays(corpus, max_seq_len=8, mode="train", use_native=True)
    others = [datasets.build_dense_t5_arrays(corpus, 8, "train", use_native=False)]
    others += [jdatasets.build_dense_t5_arrays(corpus, 8, "train", use_native=n)
               for n in (False, *_jax_native())]
    _equal(got.arrays, [o.arrays for o in others])


def test_without_gxx_the_builders_take_the_python_path(tmp_path, monkeypatch, corpus):
    monkeypatch.setattr(native_packer, "BUILD_DIR", str(tmp_path / "_build"))
    monkeypatch.setattr(native_packer.shutil, "which", lambda name: None)
    assert not native_packer.available()
    got = datasets.build_sasrec_arrays(corpus, 12, "train")  # use_native=None
    want = datasets.build_sasrec_arrays(corpus, 12, "train", use_native=False)
    _equal(got.arrays, [want.arrays])
    with pytest.raises(RuntimeError, match="not available"):
        datasets.build_sasrec_arrays(corpus, 12, "train", use_native=True)
    assert not (tmp_path / "_build").exists()


def test_a_failed_compile_raises(tmp_path, monkeypatch):
    bad = tmp_path / "packer.cpp"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(native_packer, "SOURCE", str(bad))
    monkeypatch.setattr(native_packer, "BUILD_DIR", str(tmp_path / "_build"))
    with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
        native_packer.available()
    assert os.listdir(tmp_path / "_build") == []  # no half-written library left
