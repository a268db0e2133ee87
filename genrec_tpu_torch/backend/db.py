"""SQLite data layer — the 13 tables of the reference backend.

Reference: async SQLAlchemy ORM under `backend/app/models/` (13 tables:
students `student.py:34-56`, teachers `teacher.py`, announcements
`announcement.py`, knowledge_base `knowledge.py`, courses `course1.py`,
conversation+message `chat1.py`, corrective_records
`corrective_record.py`, admin_profiles `profile.py`, interest_tag
`interest_tag.py`, cultivation_plan `cultivation_plan.py`, class_index
`class_index.py:5-16`, interaction_records `interaction_records.py:6-19`)
with engine/session plumbing in `backend/app/db/`.

Rebuilt on stdlib ``sqlite3`` (same underlying database file format the
reference's `sqlite+aiosqlite` URL produces) with a thread-safe
connection wrapper, so the backend runs with zero third-party
dependencies. The `class_index` / `interaction_records` / `students`
tables are the ones the recommendation ETL consumes
(`Baseline/data_process.py:9-105` ⇒ :mod:`genrec_tpu_torch.data.etl`).
"""

from __future__ import annotations

import json
import sqlite3
import threading
from datetime import datetime, timezone
from typing import Any, Dict, Iterable, List, Optional, Sequence

# DDL for every table of the reference backend, same names and columns.
SCHEMA: Dict[str, str] = {
    "students": """
        CREATE TABLE IF NOT EXISTS students (
            student_id TEXT PRIMARY KEY,
            name TEXT NOT NULL,
            phone TEXT,
            college TEXT,
            major TEXT,
            grade TEXT,
            password TEXT NOT NULL,
            registration_date TEXT,
            interest_profile TEXT,
            interest_long_profile TEXT
        )""",
    "teachers": """
        CREATE TABLE IF NOT EXISTS teachers (
            teacher_id TEXT PRIMARY KEY,
            name TEXT NOT NULL,
            phone TEXT,
            college TEXT,
            major TEXT,
            password TEXT NOT NULL,
            registration_date TEXT,
            interest_tags TEXT
        )""",
    "announcements": """
        CREATE TABLE IF NOT EXISTS announcements (
            id INTEGER PRIMARY KEY AUTOINCREMENT,
            title TEXT NOT NULL,
            content TEXT NOT NULL,
            status TEXT,
            publish_date TEXT
        )""",
    "knowledge_base": """
        CREATE TABLE IF NOT EXISTS knowledge_base (
            id INTEGER PRIMARY KEY AUTOINCREMENT,
            document_name TEXT NOT NULL,
            uploader TEXT,
            document_content TEXT NOT NULL,
            upload_time TEXT
        )""",
    "courses": """
        CREATE TABLE IF NOT EXISTS courses (
            id INTEGER PRIMARY KEY AUTOINCREMENT,
            name TEXT NOT NULL,
            teacher TEXT NOT NULL,
            description TEXT,
            category TEXT
        )""",
    "conversation": """
        CREATE TABLE IF NOT EXISTS conversation (
            id INTEGER PRIMARY KEY AUTOINCREMENT,
            user_id TEXT NOT NULL,
            title TEXT,
            created_at TEXT NOT NULL,
            updated_at TEXT NOT NULL
        )""",
    "message": """
        CREATE TABLE IF NOT EXISTS message (
            id INTEGER PRIMARY KEY AUTOINCREMENT,
            conversation_id INTEGER NOT NULL REFERENCES conversation(id),
            role TEXT NOT NULL,
            content TEXT NOT NULL,
            timestamp TEXT NOT NULL
        )""",
    "corrective_records": """
        CREATE TABLE IF NOT EXISTS corrective_records (
            id TEXT PRIMARY KEY,
            document TEXT NOT NULL,
            mark_records TEXT
        )""",
    "admin_profiles": """
        CREATE TABLE IF NOT EXISTS admin_profiles (
            admin_id TEXT PRIMARY KEY,
            name TEXT NOT NULL,
            phone TEXT,
            password TEXT NOT NULL,
            create_time TEXT,
            last_update_time TEXT
        )""",
    "interest_tag": """
        CREATE TABLE IF NOT EXISTS interest_tag (
            id INTEGER PRIMARY KEY AUTOINCREMENT,
            tag TEXT NOT NULL
        )""",
    "cultivation_plan": """
        CREATE TABLE IF NOT EXISTS cultivation_plan (
            id INTEGER PRIMARY KEY,
            learning_stage TEXT,
            major TEXT,
            training_target TEXT,
            major_introduction TEXT,
            main_courses TEXT
        )""",
    "class_index": """
        CREATE TABLE IF NOT EXISTS class_index (
            class_id INTEGER PRIMARY KEY,
            class_name TEXT,
            content TEXT,
            keywords_pos TEXT,
            keywords_neg TEXT,
            url TEXT
        )""",
    "interaction_records": """
        CREATE TABLE IF NOT EXISTS interaction_records (
            id INTEGER PRIMARY KEY AUTOINCREMENT,
            student_id TEXT NOT NULL,
            class_id INTEGER NOT NULL,
            class_name TEXT,
            keywords_pos TEXT,
            keywords_neg TEXT,
            preference TEXT
        )""",
}

TABLES: List[str] = list(SCHEMA)


def utcnow_iso() -> str:
    return datetime.now(timezone.utc).replace(tzinfo=None).isoformat()


class Database:
    """Thread-safe sqlite3 wrapper (one connection, serialized writes).

    The stdlib HTTP adapter serves from a thread pool; sqlite3 handles
    cross-thread use when guarded by a lock and
    ``check_same_thread=False``.
    """

    def __init__(self, path: str = ":memory:"):
        self.path = path
        self._conn = sqlite3.connect(path, check_same_thread=False)
        self._conn.row_factory = sqlite3.Row
        self._lock = threading.Lock()

    def close(self) -> None:
        self._conn.close()

    def create_all(self) -> None:
        with self._lock:
            for ddl in SCHEMA.values():
                self._conn.execute(ddl)
            self._conn.commit()

    def execute(self, sql: str, params: Sequence[Any] = ()) -> sqlite3.Cursor:
        with self._lock:
            cur = self._conn.execute(sql, params)
            self._conn.commit()
            return cur

    def executemany(self, sql: str, rows: Iterable[Sequence[Any]]) -> None:
        with self._lock:
            self._conn.executemany(sql, rows)
            self._conn.commit()

    def query(self, sql: str, params: Sequence[Any] = ()) -> List[Dict[str, Any]]:
        with self._lock:
            cur = self._conn.execute(sql, params)
            return [dict(r) for r in cur.fetchall()]

    def query_one(self, sql: str, params: Sequence[Any] = ()) -> Optional[Dict[str, Any]]:
        rows = self.query(sql, params)
        return rows[0] if rows else None

    def insert(self, table: str, row: Dict[str, Any]) -> int:
        cols = ", ".join(row)
        ph = ", ".join("?" * len(row))
        cur = self.execute(
            f"INSERT INTO {table} ({cols}) VALUES ({ph})", list(row.values()))
        return int(cur.lastrowid or 0)

    def count(self, table: str) -> int:
        return int(self.query_one(f"SELECT COUNT(*) AS n FROM {table}")["n"])

    def table_names(self) -> List[str]:
        return [r["name"] for r in self.query(
            "SELECT name FROM sqlite_master WHERE type='table' "
            "AND name NOT LIKE 'sqlite_%' ORDER BY name")]

    # -- conversation/message helpers (reference `chat1.py` usage) -------
    def new_conversation(self, user_id: str, title: Optional[str] = None) -> int:
        now = utcnow_iso()
        return self.insert("conversation", {
            "user_id": user_id, "title": title,
            "created_at": now, "updated_at": now})

    def add_message(self, conversation_id: int, role: str, content: str) -> int:
        mid = self.insert("message", {
            "conversation_id": conversation_id, "role": role,
            "content": content, "timestamp": utcnow_iso()})
        self.execute("UPDATE conversation SET updated_at=? WHERE id=?",
                     (utcnow_iso(), conversation_id))
        return mid

    def dump_json(self) -> str:
        return json.dumps({t: self.count(t) for t in self.table_names()})
