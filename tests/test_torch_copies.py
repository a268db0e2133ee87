"""The port's copies of the JAX package's framework-free modules, held
against the originals on the same inputs:

- ``utils/xlsx.py``: each package reads the other's workbook, and
  ``load_major_hierarchy_xlsx`` gives the same levels
  (``tests/test_utils.py:75``'s workbook);
- ``encoding/bert_encoders.py`` on its ``encoder=None`` path: the item,
  user and major-hierarchy encoders, ``word_drop``,
  ``user_embedding_from_items``, ``top5_major_retrieval`` and the
  prof_lvl files of ``build_prof_lvl_files`` (``tests/test_serving.py:100``,
  :122);
- ``encoding/stu_major.py`` on a small interaction CSV;
- ``utils/visualize.py``'s distances, counts and CSVs
  (``tests/test_utils.py:15-40``); matplotlib waits for a plot;
- ``backend/schemas.py``: every pydantic model, field for field, with no
  pydantic import until a model is asked for;
- ``utils/misc.py``'s ``ensure_dir``, ``get_local_time``, ``set_color`` and
  ``delete_file`` with ``utils/__init__.py``'s re-exports, ``configs.replace``
  and ``utils/plotting.py``'s ``plot_training_curves`` (the same PNG bytes
  where matplotlib is installed; no matplotlib import without a path).
"""

import csv
import pathlib
import subprocess
import sys

import numpy as np
import pytest

from genrec_tpu.encoding import bert_encoders as jbert
from genrec_tpu.encoding import stu_major as jstu
from genrec_tpu.utils import visualize as jviz
from genrec_tpu.utils import xlsx as jxlsx
from genrec_tpu_torch.encoding import bert_encoders, stu_major
from genrec_tpu_torch.utils import visualize, xlsx

SHEETS = {
    "Level1": [
        ["大类代码", "大类名称", "大类简介及培养目标", "大类通识课程"],
        ["01", "哲学", "研究智慧之学", "哲学导论, 逻辑学"],
        [None, "空行应被跳过", "x", "y"],
        ["02", "经济学", None, "微观经济学"],
    ],
    "Level2": [
        ["代码", "名称", "简介", "核心课程"],
        ["0101", "哲学", "本专业培养...", "中国哲学史"],
        ["0101", "伦理学", "分流专业同码", None],
    ],
    "Level3": [
        ["代码", "名称", "学类简介及培养目标"],
        ["010101", "马克思主义哲学", "简介文本"],
        ["010102", "外国哲学", None],
    ],
}


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_xlsx_round_trip_and_major_hierarchy(tmp_path, writer):
    """A workbook written by either package reads alike in both, and the
    3-sheet major hierarchy ingests to the same levels and embeddings."""
    path = str(tmp_path / "majors.xlsx")
    (xlsx if writer == "port" else jxlsx).write_xlsx(path, SHEETS)
    for mod in (xlsx, jxlsx):
        wb = mod.Workbook(path)
        try:
            assert wb.sheet_names == ["Level1", "Level2", "Level3"]
            rows = {s: wb.rows(s) for s in wb.sheet_names}
        finally:
            wb.close()
        if mod is xlsx:
            got = rows
        else:
            assert rows == got
    levels = bert_encoders.load_major_hierarchy_xlsx(path)
    assert levels == jbert.load_major_hierarchy_xlsx(path)
    assert levels[2][1] == ("010102", "外国哲学", "外国哲学")  # an empty intro: the name
    for g, w in zip(bert_encoders.encode_major_hierarchy(levels, dim=32),
                    jbert.encode_major_hierarchy(levels, encoder=None, dim=32)):
        assert list(g["codes"]) == list(w["codes"]) and list(g["names"]) == list(w["names"])
        np.testing.assert_array_equal(g["embs"], w["embs"])
    mixed = str(tmp_path / "mixed.xlsx")
    (xlsx if writer == "port" else jxlsx).write_xlsx(mixed, {"S": [["a", 1, 2.5, True, None, "b"]]})
    wb = xlsx.Workbook(mixed)
    assert wb.rows("S")[0] == ["a", 1, 2.5, True, None, "b"]
    wb.close()


def test_encoders_without_weights_equal_the_reference():
    items = {1: "algebra and logic", 2: "calculus", 5: "poetry of the north"}
    for ratio in (-1.0, 0.4):
        got = bert_encoders.encode_item_texts(items, dim=32, word_drop_ratio=ratio, seed=3)
        want = jbert.encode_item_texts(items, None, 32, word_drop_ratio=ratio, seed=3)
        np.testing.assert_array_equal(got, want)
        assert got.shape == (6, 32) and not got[0].any()
    users = {2: "bob", 1: "alice", 7: ""}
    np.testing.assert_array_equal(bert_encoders.encode_user_profiles(users, dim=16),
                                  jbert.encode_user_profiles(users, None, 16))
    texts = ["a b c d e f", "one two", ""]
    assert (bert_encoders.word_drop(texts, 0.5, np.random.default_rng(1))
            == jbert.word_drop(texts, 0.5, np.random.default_rng(1)))
    embs = np.arange(20, dtype=np.float32).reshape(5, 4)
    for hist in ([1, 2, 3], [4], []):
        np.testing.assert_array_equal(bert_encoders.user_embedding_from_items(embs, hist),
                                      jbert.user_embedding_from_items(embs, hist))


@pytest.mark.parametrize("n_majors", [8, 3])
def test_top5_major_retrieval_and_prof_files(tmp_path, n_majors):
    """Cosine top-5 (padded with -1 below 5 majors) and the prof_lvl files
    the two packages write."""
    from genrec_tpu.data.contracts import read_prof_lvl as jread
    from genrec_tpu_torch.data.contracts import read_prof_lvl

    rng = np.random.default_rng(n_majors)
    majors = [rng.normal(size=(n_majors, 16)).astype(np.float32) for _ in range(3)]
    users = rng.normal(size=(6, 16)).astype(np.float32)
    for got, want in zip(bert_encoders.top5_major_retrieval(users, majors[0]),
                         jbert.top5_major_retrieval(users, majors[0])):
        np.testing.assert_array_equal(got, want)
    uids = np.arange(1, 7, dtype=np.int32)
    paths = {k: [str(tmp_path / f"{k}_lvl{i}.h5") for i in (1, 2, 3)] for k in ("port", "jax")}
    bert_encoders.build_prof_lvl_files(uids, users, majors, paths["port"])
    jbert.build_prof_lvl_files(uids, users, majors, paths["jax"])
    for p, j in zip(paths["port"], paths["jax"]):
        for got, want in zip(read_prof_lvl(p), jread(j)):
            np.testing.assert_array_equal(got, want)


def test_stu_major_equals_the_reference(tmp_path):
    """Per-student means of the per-interaction vectors (malformed and
    wrong-width vectors skipped), top-k retrieval and the prof files."""
    from genrec_tpu.data.contracts import read_prof_lvl as jread
    from genrec_tpu_torch.data.contracts import read_prof_lvl

    rng = np.random.default_rng(0)
    path = tmp_path / "records.csv"
    with open(path, "w", newline="", encoding="utf-8") as f:
        w = csv.writer(f)
        w.writerow(["student_id", "course", "BERT_Vector"])
        for sid in ("s3", "s1", "s3", "s2", "s1", ""):
            w.writerow([sid, "c", str(rng.normal(size=8).round(4).tolist())])
        w.writerow(["s2", "c", "not a vector"])
        w.writerow(["s4", "c", str([1.0, 2.0])])
    got = stu_major.load_student_matrix(str(path), emb_dim=8)
    want = jstu.load_student_matrix(str(path), emb_dim=8)
    assert got[0] == want[0] == ["s3", "s1", "s2", "s4"]
    np.testing.assert_array_equal(got[1], want[1])
    majors = [rng.normal(size=(7, 8)).astype(np.float32) for _ in range(3)]
    for g, w in zip(stu_major.retrieve_top_k(got[1], majors[0], 3),
                    jstu.retrieve_top_k(want[1], majors[0], 3)):
        np.testing.assert_array_equal(g, w)
    outs = {k: [str(tmp_path / f"{k}{i}.h5") for i in (1, 2, 3)] for k in ("port", "jax")}
    with pytest.MonkeyPatch.context() as mp:  # both read 8-wide vectors
        mp.setattr(stu_major, "EMB_DIM", 8)
        mp.setattr(jstu, "EMB_DIM", 8)
        mp.setattr(stu_major.load_student_matrix, "__defaults__", (8,))
        mp.setattr(jstu.load_student_matrix, "__defaults__", (8,))
        stu_major.build_prof_files_from_csv(str(path), majors, outs["port"], top_k=3)
        jstu.build_prof_files_from_csv(str(path), majors, outs["jax"], top_k=3)
    for p, j in zip(outs["port"], outs["jax"]):
        for g, w in zip(read_prof_lvl(p), jread(j)):
            np.testing.assert_array_equal(g, w)


def test_visualize_equals_the_reference(tmp_path):
    assert visualize.longest_common_prefix_len([1, 2, 3], [1, 2, 9]) == 2
    codes = np.random.default_rng(4).integers(0, 3, size=(40, 4))
    np.testing.assert_array_equal(visualize.prefix_distance_matrix(codes),
                                  jviz.prefix_distance_matrix(codes))
    for depth in (1, 2, 3):
        assert visualize.prefix_counts(codes, depth) == jviz.prefix_counts(codes, depth)
    names = [f"course {i}" for i in range(30)]  # fewer names than rows
    visualize.write_summary_csvs(codes, names, str(tmp_path / "port"))
    jviz.write_summary_csvs(codes, names, str(tmp_path / "jax"))
    for f in ("course_semantic_id_alignment.csv", "prefix1_counts.csv", "prefix2_counts.csv"):
        assert (tmp_path / "port" / f).read_text() == (tmp_path / "jax" / f).read_text(), f


def test_heavy_imports_wait_for_their_use():
    """Importing the copies imports neither matplotlib, sklearn nor pydantic."""
    code = ("import sys\n"
            "import genrec_tpu_torch.utils.visualize, genrec_tpu_torch.backend.schemas\n"
            "import genrec_tpu_torch.encoding.stu_major, genrec_tpu_torch.utils.xlsx\n"
            "bad = [m for m in ('matplotlib', 'sklearn', 'pydantic') if m in sys.modules]\n"
            "assert not bad, bad\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=120, cwd=str(pathlib.Path(__file__).resolve().parents[1]))
    assert out.returncode == 0, out.stderr


def _schema_names():
    from genrec_tpu_torch.backend import schemas

    return schemas.NAMES


@pytest.mark.parametrize("name", _schema_names())
def test_schema_model_equals_the_reference(name):
    from genrec_tpu.backend import schemas as jschemas
    from genrec_tpu_torch.backend import schemas

    got, want = getattr(schemas, name), getattr(jschemas, name)
    assert got.__name__ == want.__name__ == name
    assert got.model_fields.keys() == want.model_fields.keys()
    for field, g in got.model_fields.items():
        w = want.model_fields[field]
        # the same type, a nested model named in its own package
        assert str(g.annotation).replace("genrec_tpu_torch.", "genrec_tpu.") == str(
            w.annotation), field
        assert g.is_required() == w.is_required(), field
        assert g.get_default(call_default_factory=True) == w.get_default(
            call_default_factory=True), field
    assert got.model_json_schema() == want.model_json_schema()


def test_schemas_cover_every_reference_model():
    from pydantic import BaseModel

    from genrec_tpu.backend import schemas as jschemas

    reference = {k for k, v in vars(jschemas).items()
                 if isinstance(v, type) and issubclass(v, BaseModel) and v is not BaseModel}
    assert reference == set(_schema_names())


def test_misc_copies_equal_the_reference(tmp_path):
    import datetime

    import genrec_tpu.utils as jutils
    from genrec_tpu.utils import misc as jmisc
    import genrec_tpu_torch.utils as utils
    from genrec_tpu_torch.utils import misc

    public = {"ensure_dir", "set_color", "get_local_time", "append_results_csv"}
    assert public <= set(vars(utils)) and public <= set(vars(jutils))
    for color in ("black", "red", "green", "yellow", "blue", "pink", "cyan", "white", "mauve"):
        for highlight in (True, False):
            assert misc.set_color("msg", color, highlight) == jmisc.set_color("msg", color,
                                                                              highlight)
    fmt = "%b-%d-%Y_%H-%M-%S"
    got, want = (datetime.datetime.strptime(m.get_local_time(), fmt) for m in (misc, jmisc))
    assert abs((got - want).total_seconds()) <= 2
    for mod, name in ((misc, "port"), (jmisc, "jax")):
        path = tmp_path / name / "a" / "b"
        mod.ensure_dir(str(path))
        mod.ensure_dir(str(path))  # exists already: no error
        f = path / "x.txt"
        f.write_text("x")
        mod.delete_file(str(f))
        mod.delete_file(str(f))  # gone already: no error
        assert path.is_dir() and not f.exists()


def test_configs_replace_equals_the_reference():
    import dataclasses

    from genrec_tpu import configs as jconfigs
    from genrec_tpu_torch import configs

    got = configs.replace(configs.SASRecConfig(), d=64, max_len=30)
    want = jconfigs.replace(jconfigs.SASRecConfig(), d=64, max_len=30)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert (got.d, got.max_len) == (64, 30) and configs.SASRecConfig().d != 64
    with pytest.raises(TypeError):
        configs.replace(configs.SASRecConfig(), no_such_field=1)


@pytest.mark.parametrize("metrics", [None, {"Recall@10": [0.1, 0.2, 0.3]},
                                     {"Recall@10": [0.1, 0.2], "NDCG@10": [0.05, 0.1],
                                      "Hit@5": [0.2, 0.4]}])
def test_plot_training_curves_equals_the_reference(tmp_path, metrics):
    from genrec_tpu.utils import plotting as jplotting
    from genrec_tpu_torch.utils import plotting

    losses = [1.0, 0.6, 0.4]
    assert plotting.plot_training_curves(losses, metrics, None) is None
    try:
        import matplotlib  # noqa: F401
    except ImportError:  # without matplotlib only the save_path=None return can run
        return
    got, want = tmp_path / "port" / "curves.png", tmp_path / "jax" / "curves.png"
    plotting.plot_training_curves(losses, metrics, str(got))
    jplotting.plot_training_curves(losses, metrics, str(want))
    assert got.read_bytes() == want.read_bytes()


def test_plots_import_matplotlib_only_for_a_path():
    code = ("import sys\n"
            "import genrec_tpu_torch.utils\n"
            "from genrec_tpu_torch.utils import plotting\n"
            "plotting.plot_training_curves([1.0, 0.5], {'Recall@10': [0.1, 0.2]}, None)\n"
            "plotting.plot_loss_curves([1.0, 0.5], [1.1, 0.6], None)\n"
            "assert 'matplotlib' not in sys.modules\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=120, cwd=str(pathlib.Path(__file__).resolve().parents[1]))
    assert out.returncode == 0, out.stderr
