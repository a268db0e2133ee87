"""The port's serving app (genrec_tpu_torch/serving/{recommend,evaluation,app}.py,
encoding/bert_encoders.py, data/etl.py) against the JAX package's, and the
``/api/v1/recommend/model`` route over HTTP, on the CPU at tiny sizes.

- The copied modules give JAX's outputs on the same inputs and seeds:
  ``_hash_embed``, the hybrid recommender's scores and lists, its
  leave-one-out evaluation, the LLM client's requests, and the ETL's arrays
  and files.
- ``make_sasrec_recommend_fn``, ported to torch, gives the JAX function's
  lists on converted weights, out-of-range and negative ids included. The
  JAX function as it stands raises on every call (NumPy's view of a
  ``jax.Array`` is read-only, so its ``logits[0] = -1e9`` fails); it runs
  here with its ``np.asarray`` returning a writable copy and nothing else
  changed.
- The route answers each model fn's own list for TIGER, DenseT5 and SASRec,
  and for TIGER the JAX ``tiger_model_fn``'s list on converted weights.
"""

import dataclasses
import json
import random
import sqlite3
import threading
import types
import urllib.request

import h5py
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from genrec_tpu import configs as jconfigs
from genrec_tpu.data import etl as jetl
from genrec_tpu.encoding.bert_encoders import _hash_embed as jax_hash_embed
from genrec_tpu.models.sasrec import SASRec as JaxSASRec
from genrec_tpu.models.tiger import TIGER as JaxTIGER
from genrec_tpu.serving import app as japp
from genrec_tpu.serving import evaluation as jeval
from genrec_tpu.serving import recommend as jrec
from genrec_tpu.serving.model_fn import tiger_model_fn as jax_tiger_model_fn
from genrec_tpu.train.checkpoint import CheckpointStore
from genrec_tpu_torch import configs
from genrec_tpu_torch.backend.api import AppContext
from genrec_tpu_torch.backend.config import Settings
from genrec_tpu_torch.backend.server import BackendHTTPServer
from genrec_tpu_torch.convert import sasrec_params_from_flax, tiger_params_from_flax
from genrec_tpu_torch.data import etl as petl
from genrec_tpu_torch.data.contracts import InteractionData, write_codes
from genrec_tpu_torch.data.synthetic import make_codes, make_interactions, make_item_embs
from genrec_tpu_torch.encoding.bert_encoders import _hash_embed
from genrec_tpu_torch.models.dense_t5 import DenseT5
from genrec_tpu_torch.models.sasrec import SASRec
from genrec_tpu_torch.serving import app as papp
from genrec_tpu_torch.serving import evaluation as peval
from genrec_tpu_torch.serving import recommend as prec
from genrec_tpu_torch.serving.model_fn import (dense_t5_model_fn, sasrec_model_fn,
                                               tiger_model_fn)
from genrec_tpu_torch.train.checkpoint import save_best


def _catalog(rec, n=12, dim=16):
    ids = list(range(1, n + 1))
    embs = make_item_embs(n, dim=dim, num_topics=3, seed=4)
    return rec.ItemCatalog(
        item_pool=ids, item_names={i: f"course {i} topic{i % 3}" for i in ids},
        item_keywords_pos={i: {"math", f"topic{i % 3}"} for i in ids},
        item_keywords_neg={i: {"boring"} if i % 4 == 0 else set() for i in ids},
        item_content={i: f"content {i}" if i % 2 else "" for i in ids},
        item_url={i: f"http://x/{i}" for i in ids}, item_embeddings=embs)


# --- copied modules: the same outputs on the same inputs ----------------------------------


def test_hash_embed_equals_jax():
    texts = ["", "algebra", "数据结构", "algebra", "a much longer course description"]
    for dim in (8, 256, 768):
        got = _hash_embed(texts, dim=dim)
        np.testing.assert_array_equal(got, jax_hash_embed(texts, dim=dim))
        assert got.dtype == np.float32 and not got[0].any()


def test_scoring_helpers_equal_jax():
    cat = _catalog(prec)
    history = [(1, 1), (3, 0), (4, 1), (8, 0)]
    for c in range(1, 13):
        assert (prec.f_mat(history, c, cat.item_keywords_pos, cat.item_keywords_neg)
                == jrec.f_mat(history, c, cat.item_keywords_pos, cat.item_keywords_neg))
    for hist in (history, [(2, 1)], [(5, 0)], []):
        np.testing.assert_array_equal(prec.f_sim_batch(hist, [2, 5, 6, 7], cat.item_embeddings),
                                      jrec.f_sim_batch(hist, [2, 5, 6, 7], cat.item_embeddings))
    for scores in ([2.0, 4.0, 6.0], [3.0, 3.0], [], [-1.0, 0.5]):
        assert prec.normalize_scores(scores) == jrec.normalize_scores(scores)
    for seed in range(3):
        assert (prec.get_user_history_labels([1, 2, 3], list(range(4, 12)), random.Random(seed))
                == jrec.get_user_history_labels([1, 2, 3], list(range(4, 12)),
                                                random.Random(seed)))
    for enc in (None, lambda t: _hash_embed(t, dim=32)):
        assert (prec.match_text_to_items("course 7 topic1", [5, 7, 9], cat.item_names, enc)
                == jrec.match_text_to_items("course 7 topic1", [5, 7, 9], cat.item_names, enc))


def _fake_llm(user_prompt, system_prompt):
    return "course 7 topic1\n" + ("course 9" if "10" in system_prompt else "course 3")


@pytest.mark.parametrize("history,profile,llm,k", [
    ([1, 2, 3], "cs student", False, 5), ([1], "x", True, 3), ([], "cs student", False, 4),
    ([], "ml", True, 4), ([4, 8, 12, 2], "", True, 10), (list(range(1, 13)), "p", False, 3),
])
def test_hybrid_recommender_equals_jax(history, profile, llm, k):
    got, want = (rec.HybridRecommender(catalog=_catalog(rec), seed=0,
                                       llm_client=_fake_llm if llm else None,
                                       text_encoder=(lambda t: _hash_embed(t, dim=32))
                                       if llm else None).recommend(history, profile, k)
                 for rec in (prec, jrec))
    assert got == want
    assert not {r["item_id"] for r in got} & set(history)


def test_leave_one_out_equals_jax():
    hists = {1: [1, 2, 3], 2: [4, 5], 3: [6], 4: [7, 8, 9, 10], 5: [11, 12, 1]}
    profiles = {1: "a", 2: "b", 4: "c"}
    for max_users in (2, 14):
        got = peval.evaluate_leave_one_out(prec.HybridRecommender(catalog=_catalog(prec), seed=0),
                                           hists, profiles, k=5, max_users=max_users, seed=3)
        want = jeval.evaluate_leave_one_out(
            jrec.HybridRecommender(catalog=_catalog(jrec), seed=0), hists, profiles, k=5,
            max_users=max_users, seed=3)
        assert got == want
    assert got["num_users"] == 4


def test_catalog_from_recommendation_data_equals_jax():
    classes = {"class_ids": np.array([3, 1, 2]),
               "class_names": np.array(["c", "a", "b"], dtype=object),
               "keywords_pos": np.array(["x，y", "", "z, w"], dtype=object),
               "keywords_neg": np.array(["", "q", ""], dtype=object),
               "url": np.array(["u3", "u1", "u2"], dtype=object)}
    embs = np.arange(20, dtype=np.float64).reshape(4, 5)
    got = prec.ItemCatalog.from_recommendation_data(classes, embs)
    want = jrec.ItemCatalog.from_recommendation_data(classes, embs)
    for f in dataclasses.fields(got):
        if f.name == "item_embeddings":
            np.testing.assert_array_equal(got.item_embeddings, want.item_embeddings)
            assert got.item_embeddings.dtype == np.float32
        else:
            assert getattr(got, f.name) == getattr(want, f.name), f.name


@pytest.mark.parametrize("base_url,fmt", [("http://llm.local/v1", None),
                                          ("http://dashscope.local/api/v1", None),
                                          ("http://llm.local/v1", "dashscope")])
def test_env_llm_client_sends_what_jax_sends(monkeypatch, base_url, fmt):
    for var in ("GENREC_LLM_API_KEY", "GENREC_LLM_BASE_URL", "GENREC_LLM_API_FORMAT",
                "GENREC_LLM_MODEL"):
        monkeypatch.delenv(var, raising=False)
    assert prec.make_env_llm_client() is None and jrec.make_env_llm_client() is None
    monkeypatch.setenv("GENREC_LLM_API_KEY", "k")
    monkeypatch.setenv("GENREC_LLM_BASE_URL", base_url)
    if fmt:
        monkeypatch.setenv("GENREC_LLM_API_FORMAT", fmt)
    sent = []

    class _Reply:
        def __init__(self, body):
            self.body = body

        def read(self):
            return self.body

        def __enter__(self):
            return self

        def __exit__(self, *exc):
            return False

    def fake_urlopen(req, timeout):
        sent.append((req.full_url, json.loads(req.data), dict(req.headers), timeout))
        if "dashscope" in req.full_url or "generation" in req.full_url:
            return _Reply(json.dumps({"output": {"text": "plain"}}).encode())
        return _Reply(json.dumps({"choices": [{"message": {"content": "ans"}}]}).encode())

    monkeypatch.setattr(urllib.request, "urlopen", fake_urlopen)
    answers = [rec.make_env_llm_client()("u", "s") for rec in (prec, jrec)]
    assert answers[0] == answers[1] and sent[0] == sent[1]


# --- ETL ----------------------------------------------------------------------------------


def _h5_tree(path):
    out = {}

    def visit(name, obj):
        if isinstance(obj, h5py.Dataset):
            v = obj[()]
            out[name] = (v.tolist() if getattr(v, "dtype", None) is not None
                         and v.dtype.kind == "O" else v)
    with h5py.File(path, "r") as f:
        f.visititems(visit)
    return out


def _assert_same_files(a, b):
    ta, tb = _h5_tree(a), _h5_tree(b)
    assert sorted(ta) == sorted(tb)
    for k in ta:
        if isinstance(ta[k], np.ndarray):
            assert ta[k].dtype == tb[k].dtype, k
            np.testing.assert_array_equal(ta[k], tb[k])
        else:
            assert [np.asarray(x).tolist() for x in ta[k]] == \
                   [np.asarray(x).tolist() for x in tb[k]], k


def _app_db(path):
    conn = sqlite3.connect(path)
    conn.executescript("""
    CREATE TABLE class_index (class_id INTEGER, class_name TEXT,
        keywords_pos TEXT, keywords_neg TEXT, content TEXT, url TEXT);
    CREATE TABLE interaction_records (id INTEGER, student_id INTEGER,
        class_id INTEGER, class_name TEXT, keywords_pos TEXT,
        keywords_neg TEXT, preference REAL);
    CREATE TABLE students (student_id INTEGER, major TEXT, interest_long_profile TEXT);
    INSERT INTO class_index VALUES (2,'poetry','art','dry','c2','u2');
    INSERT INTO class_index VALUES (1,'algebra','math,logic','',NULL,'u1');
    INSERT INTO class_index VALUES (3,NULL,'x','','c3','u3');
    INSERT INTO interaction_records VALUES (1, 9, 2, 'poetry','a','',1.0);
    INSERT INTO interaction_records VALUES (2, 7, 1, 'algebra','m','',NULL);
    INSERT INTO interaction_records VALUES (3, 7, 2, 'poetry','a','',0.0);
    INSERT INTO interaction_records VALUES (4, 11, 3, 'x','','',1.0);
    INSERT INTO students VALUES (7,'cs','ml'), (9,'art',NULL);
    """)
    conn.commit()
    conn.close()


def test_app_db_etl_equals_jax(tmp_path):
    db = str(tmp_path / "app.db")
    _app_db(db)
    got = petl.extract_app_db(db, str(tmp_path / "port_rec.h5"))
    want = jetl.extract_app_db(db, str(tmp_path / "jax_rec.h5"))
    for g, w in zip(got, want):
        assert sorted(g) == sorted(w)
        for key in g:
            assert g[key].dtype == w[key].dtype, key
            np.testing.assert_array_equal(g[key], w[key])
    _assert_same_files(str(tmp_path / "port_rec.h5"), str(tmp_path / "jax_rec.h5"))
    d_p = petl.app_db_to_interactions(db, str(tmp_path / "port_ui.h5"))
    d_j = jetl.app_db_to_interactions(db, str(tmp_path / "jax_ui.h5"))
    np.testing.assert_array_equal(d_p.user_ids, d_j.user_ids)
    assert d_p.user_profiles == d_j.user_profiles == ["cs", "art", "student_11"]
    assert [s.tolist() for s in d_p.item_id_lists] == [s.tolist() for s in d_j.item_id_lists]
    _assert_same_files(str(tmp_path / "port_ui.h5"), str(tmp_path / "jax_ui.h5"))


def test_mooccube_etl_equals_jax(tmp_path):
    courses = [{"id": "C1", "name": "Algebra", "about": "vectors"},
               {"id": "C2", "name": "Poetry"}, {"id": "C1", "name": "dup"}]
    users = [{"id": "U1", "name": "ann", "course_order": ["C2", "C1", "C9"]},
             {"id": "U2", "course_order": ["C1"]}, {"id": "U1", "name": "dup"},
             {"id": "U3", "name": "bo", "course_order": []}]
    for name, rows in (("course.json", courses), ("user.json", users)):
        (tmp_path / name).write_text("\n".join(json.dumps(r) for r in rows) + "\n\n",
                                     encoding="utf-8")
    assert petl.parse_jsonl(str(tmp_path / "user.json")) == jetl.parse_jsonl(
        str(tmp_path / "user.json"))
    outs = {}
    for side, mod in (("port", petl), ("jax", jetl)):
        outs[side] = mod.mooccube_to_contracts(str(tmp_path / "course.json"),
                                               str(tmp_path / "user.json"),
                                               str(tmp_path / side))
    assert [s.tolist() for s in outs["port"].item_id_lists] == [[1, 2, 3], [2], []]
    for f in ("user_item_interact.h5", "user_id_map.h5", "course_id_map.h5", "course_info.h5"):
        _assert_same_files(str(tmp_path / "port" / f), str(tmp_path / "jax" / f))
    raw = [("u9", "p", ["a", "b", "a"]), ("u8", "q", ["c"])]
    got = petl.raw_interactions_to_contracts(raw)
    want = jetl.raw_interactions_to_contracts(raw)
    np.testing.assert_array_equal(got.user_ids, want.user_ids)
    assert [s.tolist() for s in got.item_id_lists] == [s.tolist() for s in want.item_id_lists]


# --- make_sasrec_recommend_fn ---------------------------------------------------------------

ITEM_NUM = 12
SAS_CFG = configs.SASRecConfig(d=8, num_blocks=1, num_heads=1, mlp_layer=16, max_len=6,
                               dropout=0.0)


@pytest.fixture(scope="module")
def sasrec_pair():
    jcfg = jconfigs.SASRecConfig(**{f.name: getattr(SAS_CFG, f.name)
                                    for f in dataclasses.fields(SAS_CFG) if f.name != "trainer"})
    jm = JaxSASRec(item_num=ITEM_NUM, cfg=jcfg)
    params = jax.tree_util.tree_map(np.asarray, jax.jit(jm.init)(jax.random.PRNGKey(2),
                                                                 jnp.zeros((1, 6), jnp.int32)))
    model = SASRec(ITEM_NUM, SAS_CFG)
    model.load_state_dict(sasrec_params_from_flax(params, ITEM_NUM, SAS_CFG))
    return jm, params, model.eval()


def _writable_np():
    shim = types.SimpleNamespace(**{k: getattr(np, k) for k in dir(np)
                                    if not k.startswith("__")})
    shim.asarray = lambda a, *args, **kw: np.array(a, *args, **kw)
    return shim


@pytest.mark.parametrize("history", [
    [], [1, 2, 3], [5, 9, 2, 0, 7], list(range(1, 12)),
    [3, ITEM_NUM + 1], [3, 99], [-1, 4], [-(ITEM_NUM + 1), 2], [-(ITEM_NUM + 2), 2],
    [200, 1, 2, 3, 4, 5, 6, 7], [4, 4, 4],
])
def test_make_sasrec_recommend_fn_gives_the_jax_lists(sasrec_pair, monkeypatch, history):
    """Pinned from JAX: an id past the table (13 or 99 here) in the last
    ``max_len`` ids makes every logit NaN, so the list is the padding row and
    the in-range history at −1e9 first, then every other id in the order
    NumPy's argsort leaves NaNs (index order at 13 ids);
    a negative id in [−13, 0) reads the table's row 13 + id, unmasked; a
    lower one is NaN as well."""
    jm, params, model = sasrec_pair
    monkeypatch.setattr(japp, "np", _writable_np())
    jfn = japp.make_sasrec_recommend_fn(jm, params, SAS_CFG.max_len)
    fn = papp.make_sasrec_recommend_fn(model, SAS_CFG.max_len)
    for top_k in (5, ITEM_NUM + 1):
        assert fn(history, top_k) == jfn(history, top_k), (history, top_k)
    if history in ([3, ITEM_NUM + 1], [3, 99]):
        assert fn(history, ITEM_NUM + 1) == [0, 3] + [i for i in range(1, 13) if i != 3]
    with pytest.raises(OverflowError):
        fn(history + [2 ** 33], 5)
    with pytest.raises(OverflowError):
        jfn(history + [2 ** 33], 5)


def test_make_sasrec_recommend_fn_runs_without_grad_in_threads(sasrec_pair):
    """Each request of the threaded server runs on its own thread, where
    grad mode is on by default: the fn holds no_grad in its own body."""
    _, _, model = sasrec_pair
    fn = papp.make_sasrec_recommend_fn(model, SAS_CFG.max_len)
    out = {}
    t = threading.Thread(target=lambda: out.setdefault("items", fn([1, 2], 4)))
    t.start()
    t.join(timeout=30)
    assert not t.is_alive() and len(out["items"]) == 4
    seen = []
    orig = model.encode
    model.encode = lambda emb: seen.append(torch.is_grad_enabled()) or orig(emb)
    try:
        fn([1], 3)
    finally:
        del model.encode
    assert seen == [False]


# --- /api/v1/recommend/model over HTTP ------------------------------------------------------

N_ITEMS = 30
TIGER_CFG = configs.TIGERConfig(
    arch=configs.T5ArchConfig(num_layers=1, num_decoder_layers=1, d_model=16, d_ff=32,
                              num_heads=2, d_kv=8),
    max_len=4, beam_size=5)


def _post(srv, body):
    req = urllib.request.Request(
        f"http://127.0.0.1:{srv.server_address[1]}/api/v1/recommend/model",
        data=json.dumps(body).encode(), method="POST",
        headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=30) as r:
        return r.status, json.loads(r.read())


def _tiger_fns(tmp_path):
    """The port's and JAX's ``tiger_model_fn`` on one Flax init."""
    codes = make_codes(N_ITEMS, seed=3)
    codes_path = str(tmp_path / "course" / "course_rqvae_codes.npy")
    write_codes(codes_path, codes)
    jarch = jconfigs.T5ArchConfig(**dataclasses.asdict(TIGER_CFG.arch))
    jcfg = jconfigs.TIGERConfig(arch=jarch, max_len=4, beam_size=5, code_path=codes_path)
    seq = jcfg.max_len * jcfg.code_dim
    params = jax.tree_util.tree_map(np.asarray, jax.jit(JaxTIGER(jcfg).init)(
        jax.random.PRNGKey(4), jnp.zeros((1, seq), jnp.int32), jnp.ones((1, seq), jnp.int32),
        jnp.ones((1, 4), jnp.int32)))
    store = CheckpointStore(str(tmp_path / "jax_tiger"))
    store.save_best({"params": params})
    store.wait()
    jfn = jax_tiger_model_fn(str(tmp_path / "jax_tiger"), codes_path, cfg=jcfg)
    store.close()
    save_best(tiger_params_from_flax(params, TIGER_CFG), str(tmp_path / "tiger"))
    fn = tiger_model_fn(str(tmp_path / "tiger"), codes_path, cfg=TIGER_CFG, device="cpu")
    return fn, jfn


def _dense_fn(tmp_path):
    cfg = configs.DenseT5Config(
        arch=configs.T5ArchConfig(d_model=16, num_layers=1, num_heads=2, d_kv=8, d_ff=32),
        input_emb_dim=8, target_emb_dim=8, max_seq_len=5)
    save_best(DenseT5(cfg, generator=torch.Generator().manual_seed(0)).state_dict(),
              str(tmp_path / "dense"))
    items = make_item_embs(N_ITEMS, dim=8, num_topics=3, seed=1)
    return dense_t5_model_fn(str(tmp_path / "dense"), items, cfg=cfg, device="cpu")


def _sasrec_fn(tmp_path):
    data = make_interactions(num_users=20, num_items=N_ITEMS, min_len=3, max_len=8, seed=0)
    save_best(SASRec(data.max_item_id, SAS_CFG, generator=torch.Generator().manual_seed(0))
              .state_dict(), str(tmp_path / "sasrec"))
    return sasrec_model_fn(str(tmp_path / "sasrec"), data, cfg=SAS_CFG, device="cpu")


HISTORIES = [[], [3, 7, 11], list(range(1, 21)), [2, N_ITEMS + 5, -1, 0]]


@pytest.mark.parametrize("model", ["tiger", "dense_t5", "sasrec"])
def test_recommend_model_route_answers_the_model_fn(tmp_path, model):
    jfn = None
    if model == "tiger":
        fn, jfn = _tiger_fns(tmp_path)
    else:
        fn = (_dense_fn if model == "dense_t5" else _sasrec_fn)(tmp_path)
    ctx = AppContext.create(settings=Settings(database_path=str(tmp_path / "app.db")),
                            model_recommend_fn=fn)
    srv = BackendHTTPServer(ctx, "127.0.0.1", 0)
    threading.Thread(target=srv.serve_forever, args=(0.05,), daemon=True).start()
    try:
        for hist in HISTORIES:
            status, body = _post(srv, {"history": hist, "top_k": 5})
            got = [r["item_id"] for r in body["data"]]
            assert status == 200 and body["success"] is True
            assert got == fn(hist, 5), (model, hist)
            assert 0 < len(got) <= 5 and all(1 <= i <= N_ITEMS for i in got)
            assert not set(got) & set(hist[-4:])  # every model's window holds 4 ids
            if jfn is not None:
                assert got == jfn(hist, 5), hist
        status, body = _post(srv, {"top_k": 3})
        assert status == 200 and [r["item_id"] for r in body["data"]] == fn([], 3)
    finally:
        srv.shutdown()
        srv.server_close()
        ctx.db.close()
