"""The port's backend (genrec_tpu_torch/backend/) against the JAX package's,
which it copies: the route table, the SQLite schema, route matching on the
legacy prefixes and aliases, ``init_db`` on the same CSVs, the services, the
settings, and one parametrised test that sends the same request sequence to
a JAX and a port stdlib server and compares their statuses and bodies
(timestamps masked).
"""

import json
import os
import re
import threading
import urllib.error
import urllib.request

import numpy as np
import pytest

from genrec_tpu.backend import api as japi
from genrec_tpu.backend import config as jconfig
from genrec_tpu.backend import db as jdb
from genrec_tpu.backend import init_db as jinit
from genrec_tpu.backend import server as jserver
from genrec_tpu.backend import services as jservices
from genrec_tpu.backend import utils as jutils
from genrec_tpu.backend import view_db as jview
from genrec_tpu.serving import recommend as jrec
from genrec_tpu_torch.backend import api as papi
from genrec_tpu_torch.backend import config as pconfig
from genrec_tpu_torch.backend import db as pdb
from genrec_tpu_torch.backend import init_db as pinit
from genrec_tpu_torch.backend import server as pserver
from genrec_tpu_torch.backend import services as pservices
from genrec_tpu_torch.backend import utils as putils
from genrec_tpu_torch.backend import view_db as pview
from genrec_tpu_torch.serving import recommend as prec

SIDES = {
    "jax": dict(api=japi, config=jconfig, db=jdb, server=jserver, services=jservices,
                rec=jrec),
    "port": dict(api=papi, config=pconfig, db=pdb, server=pserver, services=pservices,
                 rec=prec),
}
_ISO = re.compile(r"^\d{4}-\d{2}-\d{2}T\d{2}:\d{2}:\d{2}")


def _masked(x):
    """Timestamps become a placeholder, everything else stays."""
    if isinstance(x, dict):
        return {k: _masked(v) for k, v in x.items()}
    if isinstance(x, list):
        return [_masked(v) for v in x]
    if isinstance(x, str) and _ISO.match(x):
        return "<timestamp>"
    return x


# --- route table, schema, matching -----------------------------------------------------


def test_route_table_equals_jax():
    def table(api):
        return [(m, t, h.__name__) for m, t, h in api.ROUTES]

    assert table(papi) == table(japi)
    assert len(papi.ROUTES) == 39
    assert papi._LEGACY_GROUPS == japi._LEGACY_GROUPS
    assert papi._SEGMENT_ALIASES == japi._SEGMENT_ALIASES


def test_schema_equals_jax():
    def master(db_mod):
        db = db_mod.Database(":memory:")
        db.create_all()
        rows = db.query("SELECT type, name, tbl_name, sql FROM sqlite_master ORDER BY name")
        names = db.table_names()
        db.close()
        return rows, names

    (prow, pnames), (jrow, jnames) = master(pdb), master(jdb)
    assert prow == jrow and pnames == jnames
    assert pdb.TABLES == jdb.TABLES and len(pdb.TABLES) == 13
    assert pdb.SCHEMA == jdb.SCHEMA


@pytest.mark.parametrize("method,path", [
    ("GET", "/"), ("GET", "/health"), ("GET", "/api/v1/ppt/status/42"),
    ("POST", "/api/v1/chat/"), ("GET", "/api/chat/suggestions"), ("POST", "/api/chat/"),
    ("GET", "/api/ppt/templates"), ("GET", "/api/homework/list"),
    ("GET", "/api/learning-path/paths"), ("GET", "/api/lesson-plan/templates"),
    ("GET", "/api/text-organization/stats"), ("GET", "/api/v1/ppt-creation/templates"),
    ("GET", "/api/ppt-creation/templates"), ("GET", "/api/v1/homework-grading/list"),
    ("GET", "/api/homework-grading/list"), ("GET", "/api/v1/homework_grading/list"),
    ("GET", "/api/v1/learning_path/paths/7"), ("POST", "/api/ppt-creation/create"),
    ("POST", "/api/homework-grading/submit"), ("PUT", "/api/v1/lesson-plan/plans/3"),
    ("DELETE", "/api/text-organization/documents/5"),
    ("POST", "/api/files/upload/pdf"), ("POST", "/api/recommend"),
    ("POST", "/api/v1/recommend/model"), ("GET", "/api/v1/nope"), ("PATCH", "/health"),
])
def test_match_route_equals_jax(method, path):
    def named(api):
        m = api.match_route(method, path)
        return None if m is None else (m[0].__name__, m[1])

    assert named(papi) == named(japi)


# --- init_db, view_db --------------------------------------------------------------------


def _seed_csvs(tmp_path):
    ci = tmp_path / "class_index.csv"
    ci.write_text("class_id,class_name,keywords_pos,keywords_neg,content,url\n"
                  "1,algebra,math,,c1,u1\n2,poetry,art,dry,c2,u2\n3,physics,\"sci,math\",,c3,u3\n")
    ir = tmp_path / "interactions.csv"
    ir.write_text("student_id,class_id,class_name,keywords_pos,keywords_neg,preference\n"
                  "S007,1,algebra,m,,like\nS007,2,poetry,a,,skip\nS009,3,physics,s,,like\n")
    st = tmp_path / "students.csv"
    st.write_text("student_id,name,college,major,grade,password,interest_profile,"
                  "interest_long_profile\nS007,Ann,eng,cs,3,pw,ml,deep learning\n"
                  "S009,Bo,art,design,2,,poems,modern poetry\n")
    return str(ci), str(ir), str(st)


_SECRET_COLS = ("password", "registration_date", "create_time", "last_update_time")


def _dump(db):
    return {t: [{k: ("<secret>" if k in _SECRET_COLS else v) for k, v in r.items()}
                for r in db.query(f"SELECT * FROM {t}")] for t in db.table_names()}


@pytest.mark.parametrize("seeded", [False, True])
def test_init_db_equals_jax(tmp_path, seeded):
    csvs = _seed_csvs(tmp_path) if seeded else (None, None, None)
    pdb_, jdb_ = (mod.init_db(str(tmp_path / f"{name}.db"), *csvs)
                  for name, mod in (("port", pinit), ("jax", jinit)))
    assert _dump(pdb_) == _dump(jdb_)
    assert pdb_.count("admin_profiles") == 1
    assert pdb_.count("students") == 2
    # the port verifies the JAX package's salted hashes and the other way round
    for student, pw in ((("S001", "pw-s001"),) if not seeded else (("S007", "pw"),)):
        ph = pdb_.query_one("SELECT password FROM students WHERE student_id=?", (student,))
        jh = jdb_.query_one("SELECT password FROM students WHERE student_id=?", (student,))
        assert putils.verify_password(pw, jh["password"])
        assert jutils.verify_password(pw, ph["password"])
    assert not pinit.create_default_admin(pdb_)  # re-running never duplicates
    pdb_.close()
    jdb_.close()
    again = pinit.init_db(str(tmp_path / "port.db"), *csvs)
    assert again.count("admin_profiles") == 1 and again.count("students") == 2
    again.close()


def test_view_db_prints_what_jax_prints(tmp_path, capsys):
    path = str(tmp_path / "app.db")
    pinit.init_db(path, *_seed_csvs(tmp_path)).close()
    outs = []
    for mod in (pview, jview):
        for argv in (["--db", path], ["--db", path, "--table", "class_index", "-n", "2"]):
            mod.main(argv)
            outs.append(capsys.readouterr().out)
    assert outs[:2] == outs[2:]
    assert "class_index" in outs[0] and "physics" not in outs[1]


# --- utils, services, settings -----------------------------------------------------------


def test_utils_equal_jax():
    for mod in (putils, jutils):
        assert mod.success_response([1], "ok") == {"success": True, "message": "ok", "data": [1]}
        e = mod.ApiError(418, "teapot", {"x": 1})
        assert e.status_code == 418 and e.body == jutils.error_response("teapot", {"x": 1})
    h = putils.hash_password("secret")
    assert h.startswith("pbkdf2$") and "secret" not in h
    assert putils.verify_password("secret", h) and jutils.verify_password("secret", h)
    assert not putils.verify_password("wrong", h) and not putils.verify_password("s", "garbage")


def test_services_equal_jax():
    doc = ("Linear algebra studies vectors and matrices. " * 20 +
           "Cooking pasta requires boiling water。 " * 20 + "End!\nNext line? yes.")
    for size in (80, 500):
        assert (pservices.AIService.split_text_into_chunks(doc, size)
                == jservices.AIService.split_text_into_chunks(doc, size))
    assert (pservices.AIService().get_relevant_context("matrices and vectors", doc, top_k=2)
            == jservices.AIService().get_relevant_context("matrices and vectors", doc, top_k=2))
    np.testing.assert_array_equal(pservices.default_embed_fn(["a", "", "数学"]),
                                  jservices.default_embed_fn(["a", "", "数学"]))
    seen = {}
    for name, mod in (("port", pservices), ("jax", jservices)):
        ai = mod.AIService(llm=lambda msgs, name=name: seen.setdefault(name, msgs) and "ok")
        assert ai.ask("what are matrices?", doc, [{"role": "user", "content": "hi"}]) == "ok"
        with pytest.raises(Exception) as e:
            mod.AIService(llm=None).ask("hi")
        assert e.value.status_code == 503
    assert seen["port"] == seen["jax"]


def test_settings_equal_jax(tmp_path, monkeypatch):
    env = tmp_path / ".env"
    env.write_text("# comment\nAPP_NAME='from dotenv'\nPORT=9001\n\nCORS_ORIGINS=a, b,\n")
    monkeypatch.setenv("GENREC_LLM_MODEL", "m1")
    monkeypatch.setenv("DATABASE_PATH", "/tmp/x.db")
    p, j = pconfig.Settings.from_env(str(env)), jconfig.Settings.from_env(str(env))
    # the port keeps its frontend bundle inside the checkout; every other field is JAX's
    assert {k: v for k, v in vars(p).items() if k != "static_dir"} == \
        {k: v for k, v in vars(j).items() if k != "static_dir"}
    assert p.app_name == "from dotenv" and p.port == 9001 and p.cors_origins == ["a", "b"]
    repo_root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    assert p.resolved_static_dir().startswith(repo_root + os.sep)
    monkeypatch.setenv("STATIC_DIR", "/srv/bundle")
    assert pconfig.Settings.from_env(str(env)).resolved_static_dir() == "/srv/bundle"


def test_fastapi_adapter_parity():
    pytest.importorskip(
        "fastapi",
        reason="fastapi is not installed here; the stdlib adapter drives the same "
               "handler table, so only the FastAPI glue is untested")
    from fastapi.testclient import TestClient
    db = pdb.Database(":memory:")
    db.create_all()
    ctx = papi.AppContext(settings=pconfig.Settings(), db=db, ai=pservices.AIService(),
                          textorg=pservices.TextOrganizationService(db))
    client = TestClient(pserver.create_fastapi_app(ctx))
    assert client.get("/health").json()["status"] == "healthy"
    assert client.post("/api/v1/ppt/create", json={"title": "t", "topic": "x"}).status_code == 200


# --- the same requests to a JAX and a port server ---------------------------------------


def _catalog(rec):
    ids = list(range(1, 9))
    rng = np.random.default_rng(3)
    return rec.ItemCatalog(
        item_pool=ids, item_names={i: f"course {i}" for i in ids},
        item_keywords_pos={i: {"k", f"t{i % 3}"} for i in ids},
        item_keywords_neg={i: {"dry"} if i % 4 == 0 else set() for i in ids},
        item_content={i: f"content {i}" for i in ids}, item_url={i: f"u{i}" for i in ids},
        item_embeddings=rng.normal(size=(9, 8)).astype(np.float32))


def _server(side, case):
    m = SIDES[side]
    db = m["db"].Database(":memory:")
    db.create_all()
    llm = None if case == "chat_no_llm" else (lambda msgs: "echo: " + msgs[-1]["content"][:40])
    kw = {}
    if case == "recommend":
        cat = _catalog(m["rec"])
        kw = dict(recommender=m["rec"].HybridRecommender(catalog=cat, seed=0), catalog=cat,
                  model_recommend_fn=lambda hist, k: [i + 1 for i in hist][:k])
        db.insert("students", {"student_id": "9", "name": "n", "password": "x",
                               "major": "cs", "interest_long_profile": "ml"})
        for cls in (1, 2, 5):
            db.insert("interaction_records", {"student_id": "9", "class_id": cls})
    if case == "unconfigured":
        for cid, name in ((2, "poetry"), (1, "algebra")):
            db.insert("class_index", {"class_id": cid, "class_name": name, "url": f"u{cid}"})
    ctx = m["api"].AppContext(settings=m["config"].Settings(), db=db,
                              ai=m["services"].AIService(llm=llm),
                              textorg=m["services"].TextOrganizationService(db), **kw)
    srv = m["server"].BackendHTTPServer(ctx, "127.0.0.1", 0)
    threading.Thread(target=srv.serve_forever, args=(0.05,), daemon=True).start()
    return srv


def _send(srv, method, path, body=None, raw=None):
    url = f"http://127.0.0.1:{srv.server_address[1]}{path}"
    data = raw if raw is not None else (json.dumps(body).encode() if body is not None else None)
    req = urllib.request.Request(url, data=data, method=method,
                                 headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=10) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


SEQUENCES = {
    "root": [("GET", "/"), ("GET", "/health"), ("GET", "/api/v1/nope"),
             ("DELETE", "/health")],
    "chat": [("POST", "/api/v1/chat/ask", {"question": "什么是机器学习?"}),
             ("POST", "/api/v1/chat/", {"question": "hi", "conversation_id": 999999}),
             ("POST", "/api/v1/chat/ask", {"question": "again", "conversation_id": 1,
                                           "history": [{"role": "user", "content": "x"}]}),
             ("POST", "/api/v1/chat/ask", {}), ("GET", "/api/v1/chat/suggestions"),
             ("GET", "/api/chat/suggestions")],
    "chat_no_llm": [("POST", "/api/v1/chat/ask", {"question": "hi"})],
    "files": [("POST", "/api/v1/files/upload/pdf", {"file_name": "a.pdf", "content": "x"}),
              ("POST", "/api/v1/files/upload/image", {"file_name": "b.png"}),
              ("POST", "/api/v1/files/upload/pdf", {}),
              ("POST", "/api/files/upload/pdf", {"file_name": "a.pdf"})],
    "homework": [("POST", "/api/v1/homework/submit",
                  {"student_id": "S001", "title": "essay", "content": "my essay"}),
                 ("POST", "/api/v1/homework/submit",
                  {"student_id": "S001", "title": "essay", "content": "revised"}),
                 ("POST", "/api/v1/homework/grade", {"homework_id": 1}),
                 ("GET", "/api/v1/homework/list?page=2&page_size=2"),
                 ("GET", "/api/v1/homework/homework/3"),
                 ("GET", "/api/homework-grading/list"),
                 ("GET", "/api/v1/homework_grading/list")],
    "learning_path": [("POST", "/api/v1/learning-path/generate",
                       {"student_id": "S001", "goal": "learn torch", "weekly_hours": 3}),
                      ("PUT", "/api/v1/learning-path/paths/1/progress?phase_id=1&progress=140"),
                      ("PUT", "/api/v1/learning-path/paths/1/progress", {"phase_id": 9}),
                      ("GET", "/api/v1/learning-path/paths/1"),
                      ("GET", "/api/v1/learning_path/paths"),
                      ("PUT", "/api/v1/learning-path/paths/999/progress")],
    "lesson_plan": [("POST", "/api/v1/lesson-plan/generate",
                     {"subject": "math", "topic": "matrices"}),
                    ("PUT", "/api/v1/lesson-plan/plans/1", {"topic": "tensors", "x": 1}),
                    ("GET", "/api/v1/lesson-plan/templates"),
                    ("GET", "/api/lesson-plan/plans"),
                    ("DELETE", "/api/v1/lesson-plan/plans/1"),
                    ("GET", "/api/v1/lesson-plan/plans/1"),
                    ("POST", "/api/v1/lesson-plan/generate", {"subject": "math"})],
    "ppt": [("POST", "/api/v1/ppt/create", {"title": "Intro", "topic": "JAX", "num_slides": 3}),
            ("GET", "/api/v1/ppt/status/1"), ("GET", "/api/v1/ppt/result/1"),
            ("GET", "/api/ppt-creation/templates"), ("GET", "/api/v1/ppt/projects"),
            ("GET", "/api/v1/ppt/projects/1"), ("DELETE", "/api/v1/ppt/projects/1"),
            ("GET", "/api/v1/ppt/status/1")],
    "text_organization": [
        ("POST", "/api/v1/text-organization/upload",
         {"file_name": "doc.txt", "content": "Alpha beta. Gamma delta! 数据 结构。 Epsilon?"}),
        ("POST", "/api/v1/text-organization/process", {"document_id": 1}),
        ("POST", "/api/v1/text-organization/process", {"document_id": 7}),
        ("GET", "/api/v1/text-organization/status/1"),
        ("GET", "/api/v1/text-organization/results/1"),
        ("GET", "/api/v1/text-organization/documents"),
        ("GET", "/api/text-organization/history"),
        ("GET", "/api/v1/text-organization/stats"),
        ("DELETE", "/api/v1/text-organization/documents/1"),
        ("DELETE", "/api/v1/text-organization/documents/1")],
    "errors": [("POST", "/api/v1/chat/ask", None, b"{not json"),
               ("POST", "/api/v1/chat/ask", [1, 2, 3]),
               ("POST", "/api/v1/ppt/create", {"title": "t"}),
               ("GET", "/api/v1/ppt/status/x")],
    "recommend": [("POST", "/api/v1/recommend", {"user_id": 9, "top_k": 3}),
                  ("POST", "/api/v1/recommend", {"history": [3, 4], "profile": "p",
                                                 "top_k": 4}),
                  ("POST", "/api/v1/recommend", {"history": [], "top_k": 2}),
                  ("POST", "/api/v1/recommend/model", {"history": [3, 4, 9], "top_k": 2}),
                  ("POST", "/api/v1/recommend/model", {}),
                  ("GET", "/api/v1/courses")],
    "unconfigured": [("POST", "/api/v1/recommend", {"history": [1]}),
                     ("POST", "/api/v1/recommend/model", {"history": [1]}),
                     ("GET", "/api/v1/courses")],
}


@pytest.mark.parametrize("case", sorted(SEQUENCES))
def test_http_sequence_equals_jax(case):
    servers = {side: _server(side, case) for side in SIDES}
    try:
        answers = {side: [] for side in SIDES}
        for step in SEQUENCES[case]:
            for side, srv in servers.items():
                status, body = _send(srv, *step)
                answers[side].append((status, _masked(body)))
        assert answers["port"] == answers["jax"]
        statuses = [s for s, _ in answers["port"]]
        assert any(s == 200 for s in statuses) or case in ("chat_no_llm", "errors")
    finally:
        for srv in servers.values():
            srv.shutdown()
            srv.server_close()
