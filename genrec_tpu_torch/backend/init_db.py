"""Database initialization + seeding CLI.

Reference: `backend/scripts/init_db.py:48-227` — create-all, default
admin account, sample students, then bulk seed loads from
`class_index.xlsx` / `interaction_records.csv` / `student_model.xlsx`.

This rebuild seeds from CSV (openpyxl is not a dependency; CSV carries
the same columns) and hashes the seeded passwords (the reference stores
them in plaintext, `init_db.py:104-107` — deliberately not reproduced).

Usage::

    python -m genrec_tpu_torch.backend.init_db --db app.db \
        [--class-index class_index.csv] [--interactions interaction_records.csv] \
        [--students students.csv]
"""

from __future__ import annotations

import argparse
import csv
from typing import Dict, List, Optional

from genrec_tpu_torch.backend.db import Database, utcnow_iso
from genrec_tpu_torch.backend.utils import get_logger, hash_password

logger = get_logger("genrec_backend.init_db")


def create_default_admin(db: Database) -> bool:
    if db.query_one("SELECT admin_id FROM admin_profiles WHERE admin_id=?",
                    ("admin001",)):
        logger.info("admin001 exists, skipping")
        return False
    now = utcnow_iso()
    db.insert("admin_profiles", {
        "admin_id": "admin001", "name": "管理员", "phone": "13800000000",
        "password": hash_password("123456"),
        "create_time": now, "last_update_time": now})
    logger.info("created default admin admin001")
    return True


def insert_sample_students(db: Database) -> int:
    if db.count("students"):
        logger.info("students exist, skipping samples")
        return 0
    samples = [
        ("S001", "张三", "13900000000", "计算机学院", "软件工程", "pw-s001"),
        ("S002", "李四", "13900000001", "电子信息学院", "通信工程", "pw-s002"),
    ]
    for sid, name, phone, college, major, pw in samples:
        db.insert("students", {
            "student_id": sid, "name": name, "phone": phone,
            "college": college, "major": major,
            "password": hash_password(pw),
            "registration_date": utcnow_iso()})
    return len(samples)


def _read_csv(path: str) -> List[Dict[str, str]]:
    with open(path, "r", encoding="utf-8-sig", newline="") as f:
        return list(csv.DictReader(f))


def load_class_index(db: Database, path: str) -> int:
    rows = _read_csv(path)
    db.executemany(
        "INSERT OR REPLACE INTO class_index "
        "(class_id, class_name, content, keywords_pos, keywords_neg, url) "
        "VALUES (?,?,?,?,?,?)",
        [(int(r["class_id"]), r.get("class_name", ""), r.get("content", ""),
          r.get("keywords_pos", ""), r.get("keywords_neg", ""),
          r.get("url", "")) for r in rows])
    return len(rows)


def load_interactions(db: Database, path: str) -> int:
    rows = _read_csv(path)
    db.executemany(
        "INSERT INTO interaction_records "
        "(student_id, class_id, class_name, keywords_pos, keywords_neg, "
        "preference) VALUES (?,?,?,?,?,?)",
        [(r["student_id"], int(r["class_id"]), r.get("class_name", ""),
          r.get("keywords_pos", ""), r.get("keywords_neg", ""),
          r.get("preference", "")) for r in rows])
    return len(rows)


def load_students(db: Database, path: str) -> int:
    rows = _read_csv(path)
    for r in rows:
        if db.query_one("SELECT student_id FROM students WHERE student_id=?",
                        (r["student_id"],)):
            continue
        db.insert("students", {
            "student_id": r["student_id"], "name": r.get("name", ""),
            "college": r.get("college"), "major": r.get("major"),
            "grade": r.get("grade"),
            "password": hash_password(r.get("password", "changeme")),
            "registration_date": utcnow_iso(),
            "interest_profile": r.get("interest_profile"),
            "interest_long_profile": r.get("interest_long_profile")})
    return len(rows)


def init_db(db_path: str, class_index_csv: Optional[str] = None,
            interactions_csv: Optional[str] = None,
            students_csv: Optional[str] = None) -> Database:
    db = Database(db_path)
    db.create_all()
    create_default_admin(db)
    if students_csv:
        logger.info("loaded %d students", load_students(db, students_csv))
    else:
        insert_sample_students(db)
    if class_index_csv:
        logger.info("loaded %d classes", load_class_index(db, class_index_csv))
    if interactions_csv:
        logger.info("loaded %d interactions",
                    load_interactions(db, interactions_csv))
    return db


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--db", default="app.db")
    ap.add_argument("--class-index")
    ap.add_argument("--interactions")
    ap.add_argument("--students")
    args = ap.parse_args(argv)
    db = init_db(args.db, args.class_index, args.interactions, args.students)
    for t in db.table_names():
        logger.info("%-22s %6d rows", t, db.count(t))
    db.close()


if __name__ == "__main__":
    main()
