"""ETL builders: app SQLite → recommendation_data.h5, and raw
interaction corpora → the user_item_interact/course_info/id-map contracts.

Equivalents of `Baseline/data_process.py:9-105` (SQLite extraction) and the
MOOCCube notebook ETL (`T5/data_process.ipynb`: 1-based dense id maps,
per-user time-ordered item sequences, H5 writes). A copy of
``genrec_tpu/data/etl.py`` over the port's contracts.
"""

from __future__ import annotations

import sqlite3
from collections import defaultdict
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from genrec_tpu_torch.data import contracts


def extract_app_db(db_path: str, output_h5_path: Optional[str] = None):
    """SQLite app DB → the three grouped tables of recommendation_data.h5.

    Mirrors `Baseline/data_process.py:9-105`: class_index (id, name,
    keywords_pos/neg, content, url), interaction_records (student_id,
    class_id, keywords, preference), students (student_id, major,
    interest_long_profile).
    """
    conn = sqlite3.connect(db_path)
    cur = conn.cursor()

    def fetch(query, cols):
        cur.execute(query)
        rows = cur.fetchall()
        out = {c: [] for c in cols}
        for row in rows:
            for c, v in zip(cols, row):
                out[c].append(v if v is not None else "")
        return out

    classes_raw = fetch(
        "SELECT class_id, class_name, keywords_pos, keywords_neg, content, url "
        "FROM class_index WHERE class_name IS NOT NULL ORDER BY class_id",
        ["class_id", "class_name", "keywords_pos", "keywords_neg", "content", "url"])
    inter_raw = fetch(
        "SELECT id, student_id, class_id, class_name, keywords_pos, keywords_neg, "
        "preference FROM interaction_records ORDER BY student_id, id",
        ["id", "student_id", "class_id", "class_name", "keywords_pos",
         "keywords_neg", "preference"])
    students_raw = fetch(
        "SELECT student_id, major, interest_long_profile FROM students",
        ["student_id", "major", "interest_long_profile"])
    conn.close()

    classes = {
        "class_ids": np.asarray(classes_raw["class_id"], dtype=np.int64),
        "class_names": np.asarray(classes_raw["class_name"], dtype=object),
        "keywords_pos": np.asarray(classes_raw["keywords_pos"], dtype=object),
        "keywords_neg": np.asarray(classes_raw["keywords_neg"], dtype=object),
        "content": np.asarray(classes_raw["content"], dtype=object),
        "url": np.asarray(classes_raw["url"], dtype=object),
    }
    interactions = {
        "ids": np.asarray(inter_raw["id"], dtype=np.int64),
        "student_ids": np.asarray(inter_raw["student_id"], dtype=np.int64),
        "class_ids": np.asarray(inter_raw["class_id"], dtype=np.int64),
        "keywords_pos": np.asarray(inter_raw["keywords_pos"], dtype=object),
        "keywords_neg": np.asarray(inter_raw["keywords_neg"], dtype=object),
        "preference": np.asarray(
            [float(p) if str(p).strip() not in ("", "None") else 0.0
             for p in inter_raw["preference"]], dtype=np.float64),
    }
    students = {
        "student_ids": np.asarray(students_raw["student_id"], dtype=np.int64),
        "major": np.asarray(students_raw["major"], dtype=object),
        "interest_long_profile": np.asarray(students_raw["interest_long_profile"],
                                            dtype=object),
    }
    if output_h5_path:
        contracts.write_recommendation_data(output_h5_path, classes,
                                            interactions, students)
    return classes, interactions, students


def app_db_to_interactions(db_path: str,
                           output_h5_path: Optional[str] = None
                           ) -> contracts.InteractionData:
    """App DB interaction_records → user_item_interact.h5 contract.

    Builds 1-based contiguous user ids (the invariant every downstream
    pipeline assumes) and time-ordered per-user class sequences.
    """
    _, interactions, students = extract_app_db(db_path)
    per_user: Dict[int, List[int]] = defaultdict(list)
    for sid, cid in zip(interactions["student_ids"], interactions["class_ids"]):
        per_user[int(sid)].append(int(cid))

    major_by_sid = {int(s): str(m) for s, m in
                    zip(students["student_ids"], students["major"])}
    orig_ids = sorted(per_user)
    user_ids = np.arange(1, len(orig_ids) + 1, dtype=np.int32)
    profiles = [major_by_sid.get(s, f"student_{s}") for s in orig_ids]
    seqs = [np.asarray(per_user[s], dtype=np.int32) for s in orig_ids]
    data = contracts.InteractionData(user_ids, profiles, seqs)
    if output_h5_path:
        contracts.write_interactions(output_h5_path, data)
    return data


def build_dense_id_maps(raw_user_ids: Sequence[str],
                        raw_item_ids: Sequence[str]
                        ) -> Tuple[Dict[str, int], Dict[str, int]]:
    """MOOCCube-style 1-based dense id maps (`T5/data_process.ipynb`)."""
    user_map = {u: i + 1 for i, u in enumerate(dict.fromkeys(raw_user_ids))}
    item_map = {c: i + 1 for i, c in enumerate(dict.fromkeys(raw_item_ids))}
    return user_map, item_map


def raw_interactions_to_contracts(
    raw: Sequence[Tuple[str, str, Sequence[str]]],
    interact_path: Optional[str] = None,
    user_map_path: Optional[str] = None,
    item_map_path: Optional[str] = None,
) -> contracts.InteractionData:
    """(raw_user_id, profile, [raw_item_id...]) records → contracts.

    The MOOCCube ETL path: dense 1-based ids, vlen item sequences, id-map
    H5 side files.
    """
    raw_users = [r[0] for r in raw]
    raw_items = [i for r in raw for i in r[2]]
    user_map, item_map = build_dense_id_maps(raw_users, raw_items)

    user_ids = np.asarray([user_map[r[0]] for r in raw], dtype=np.int32)
    profiles = [r[1] for r in raw]
    seqs = [np.asarray([item_map[i] for i in r[2]], dtype=np.int32) for r in raw]
    data = contracts.InteractionData(user_ids, profiles, seqs)
    if interact_path:
        contracts.write_interactions(interact_path, data)
    if user_map_path:
        contracts.write_id_map(user_map_path, list(user_map),
                               list(user_map.values()), key_prefix="user")
    if item_map_path:
        contracts.write_id_map(item_map_path, list(item_map),
                               list(item_map.values()), key_prefix="item")
    return data


def parse_jsonl(path: str) -> List[dict]:
    """MOOCCube entity dumps are JSON-lines (`T5/data_process.ipynb` cell 2)."""
    import json
    out = []
    with open(path, "r", encoding="utf-8") as f:
        for line in f:
            line = line.strip()
            if line:
                out.append(json.loads(line))
    return out


def mooccube_to_contracts(course_json_path: str, user_json_path: str,
                          out_dir: str) -> contracts.InteractionData:
    """Full MOOCCube ETL (`T5/data_process.ipynb` cells 2-8): parse
    `course.json` (id/name/about) and `user.json` (id/name/course_order),
    build 1-based dense id maps, and write the four H5 contracts —
    user_item_interact.h5, course_id_map.h5, user_id_map.h5,
    course_info.h5. Interactions referencing unknown courses are kept in
    the id maps (every course in course_order gets a dense id, matching
    the notebook, which maps courses before filtering).
    """
    import os
    courses = parse_jsonl(course_json_path)
    users = parse_jsonl(user_json_path)

    course_info: Dict[str, Tuple[str, str]] = {}
    for c in courses:
        if c["id"] not in course_info:
            course_info[c["id"]] = (c.get("name", ""), c.get("about", ""))

    raw = []
    seen = set()
    for u in users:
        if u["id"] in seen:
            continue
        seen.add(u["id"])
        raw.append((u["id"], u.get("name", ""), list(u.get("course_order", []))))

    os.makedirs(out_dir, exist_ok=True)
    data = raw_interactions_to_contracts(
        raw,
        interact_path=os.path.join(out_dir, "user_item_interact.h5"),
        user_map_path=os.path.join(out_dir, "user_id_map.h5"),
        item_map_path=os.path.join(out_dir, "course_id_map.h5"))

    # course_info.h5 in dense-id order, courses seen only in course_order
    # get empty name/about rows (the notebook only records catalog courses)
    item_map = contracts.read_id_map(
        os.path.join(out_dir, "course_id_map.h5"), key_prefix="item")
    ordered = sorted(item_map, key=item_map.get)
    names = [course_info.get(cid, ("", ""))[0] for cid in ordered]
    abouts = [course_info.get(cid, ("", ""))[1] for cid in ordered]
    contracts.write_course_info(os.path.join(out_dir, "course_info.h5"),
                                ordered, names, abouts)
    return data
