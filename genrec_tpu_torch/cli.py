"""The port's CLI: the subcommands, flags and defaults of
``genrec_tpu/cli.py``, on the port's modules.

    python -m genrec_tpu_torch.cli synth --out data/ [--users N --items N]
    python -m genrec_tpu_torch.cli sasrec|rqvae|tiger|tiger-prefix|dense-t5 [--data-dir data/]
    python -m genrec_tpu_torch.cli etl-app-db --db backend/app.db --out data/
    python -m genrec_tpu_torch.cli init-db --db app.db
    python -m genrec_tpu_torch.cli serve [--port 8000] [--tiger-ckpt ckpt/tiger]
    python -m genrec_tpu_torch.cli check-alignment     # invariant suite (pytest)

The pipeline subcommands and ``serve`` take ``--device``: they run on the
card unless given ``--device cpu``, and raise without a card before they
read, train or listen. ``serve`` wires ``/api/v1/recommend/model`` to the
first checkpoint given of ``--tiger-ckpt``, ``--dense-t5-ckpt`` and
``--sasrec-ckpt``; :func:`make_context` builds its app context without
listening, so a caller can serve it from a thread.
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import sys

from genrec_tpu_torch.device import resolve_device


def _synth(args):
    from genrec_tpu_torch.data import contracts, synthetic, tiger_tokens
    os.makedirs(args.out, exist_ok=True)
    data = synthetic.make_interactions(args.users, args.items,
                                       min_len=3, max_len=args.max_len, seed=args.seed)
    contracts.write_interactions(os.path.join(args.out, "user_item_interact.h5"), data)
    item_embs = synthetic.make_item_embs(args.items, dim=768, seed=args.seed)
    contracts.write_item_embs(os.path.join(args.out, "course_item_embs.h5"),
                              item_embs, meta={"model_name": "synthetic"})
    user_embs = synthetic.make_user_embs(data.num_users, dim=768, seed=args.seed)
    contracts.write_user_embs(os.path.join(args.out, "user_profile_embs.h5"), user_embs)
    codes = synthetic.make_codes(args.items, seed=args.seed)
    contracts.write_codes(os.path.join(args.out, "course", "course_rqvae_codes.npy"), codes)
    train, test = tiger_tokens.build_tiger_splits(data.item_id_lists, data.user_ids, codes)
    contracts.write_tiger_split(os.path.join(args.out, "tiger", "train_dataset.h5"), train)
    contracts.write_tiger_split(os.path.join(args.out, "tiger", "test_dataset.h5"), test)
    for lvl in (1, 2, 3):
        uids, prof = synthetic.make_prof_embs(data.num_users, 5, 768, seed=args.seed + lvl)
        contracts.write_prof_lvl(os.path.join(args.out, f"prof_lvl{lvl}.h5"), uids, prof)
    print(f"synthetic dataset written to {args.out}: "
          f"{data.num_users} users, {args.items} items, "
          f"{len(train.histories)} tiger train samples")


def _with_data_dir(cfg, data_dir: str, mapping):
    return dataclasses.replace(cfg, **{
        k: os.path.join(data_dir, v) for k, v in mapping.items()})


def _trainer(cfg, args, **kw):
    return dataclasses.replace(cfg.trainer, epochs=args.epochs or cfg.trainer.epochs,
                               ckpt_dir=args.ckpt_dir, **kw)


def _sasrec(args):
    from genrec_tpu_torch.configs import SASRecConfig
    from genrec_tpu_torch.pipelines import sasrec_pipeline
    dev = resolve_device(args.device)
    cfg = _with_data_dir(SASRecConfig(), args.data_dir,
                         {"data_path": "user_item_interact.h5"})
    cfg = dataclasses.replace(cfg, trainer=_trainer(
        cfg, args, results_csv_path=os.path.join(args.ckpt_dir, "SASREC-results.csv")))
    print(sasrec_pipeline.main(cfg, device=dev))


def _rqvae(args):
    from genrec_tpu_torch.configs import RQVAEConfig
    from genrec_tpu_torch.pipelines import rqvae_pipeline
    dev = resolve_device(args.device)
    cfg = _with_data_dir(RQVAEConfig(), args.data_dir,
                         {"data_path": "course_item_embs.h5",
                          "semantic_id_file": "course/course_rqvae_codes.npy"})
    cfg = dataclasses.replace(cfg, trainer=_trainer(cfg, args))
    codes = rqvae_pipeline.main(cfg, device=dev)
    print("codes shape:", codes.shape)


def _tiger(args):
    from genrec_tpu_torch.configs import TIGERConfig
    from genrec_tpu_torch.pipelines import tiger_pipeline
    dev = resolve_device(args.device)
    cfg = _with_data_dir(TIGERConfig(), args.data_dir,
                         {"code_path": "course/course_rqvae_codes.npy",
                          "train_dataset_path": "tiger/train_dataset.h5",
                          "test_dataset_path": "tiger/test_dataset.h5"})
    cfg = dataclasses.replace(
        cfg, constrained_decoding=args.constrained, target_len_buckets=args.len_buckets,
        trainer=_trainer(cfg, args,
                         results_csv_path=os.path.join(args.ckpt_dir, "RQVAE-T5-results.csv")))
    print(tiger_pipeline.main(cfg, device=dev))


def _tiger_prefix(args):
    from genrec_tpu_torch.configs import TIGERPrefixConfig
    from genrec_tpu_torch.pipelines import tiger_prefix_pipeline
    dev = resolve_device(args.device)
    cfg = _with_data_dir(TIGERPrefixConfig(), args.data_dir,
                         {"code_path": "course/course_rqvae_codes.npy",
                          "train_dataset_path": "tiger/train_dataset.h5",
                          "test_dataset_path": "tiger/test_dataset.h5"})
    cfg = dataclasses.replace(
        cfg,
        prof_lvl_paths=tuple(os.path.join(args.data_dir, f"prof_lvl{i}.h5") for i in (1, 2, 3)),
        constrained_decoding=args.constrained, trainer=_trainer(cfg, args))
    print(tiger_prefix_pipeline.main(cfg, device=dev))


def _dense_t5(args):
    from genrec_tpu_torch.configs import DenseT5Config
    from genrec_tpu_torch.pipelines import dense_t5_pipeline
    dev = resolve_device(args.device)
    cfg = _with_data_dir(DenseT5Config(), args.data_dir,
                         {"rec_path": "user_item_interact.h5",
                          "item_emb_h5_path": "course_item_embs.h5",
                          "user_emb_h5_path": "user_profile_embs.h5"})
    cfg = dataclasses.replace(cfg, trainer=_trainer(cfg, args))
    print(dense_t5_pipeline.main(cfg, device=dev))


def _etl_app_db(args):
    from genrec_tpu_torch.data.etl import app_db_to_interactions, extract_app_db
    os.makedirs(args.out, exist_ok=True)
    extract_app_db(args.db, os.path.join(args.out, "recommendation_data.h5"))
    data = app_db_to_interactions(args.db, os.path.join(args.out, "user_item_interact.h5"))
    print(f"ETL complete: {data.num_users} users, max item {data.max_item_id}")


def _etl_mooccube(args):
    from genrec_tpu_torch.data.etl import mooccube_to_contracts
    data = mooccube_to_contracts(args.courses, args.users, args.out)
    print(f"MOOCCube ETL complete: {data.num_users} users, "
          f"max item {data.max_item_id} → {args.out}/")


def make_context(args):
    """The app context ``serve`` answers from, on ``args.device``: the
    hybrid recommender and catalog when ``recommendation_data.h5`` and
    ``course_item_embs.h5`` are in ``--data-dir``, and the trained-model
    route from the first checkpoint given of TIGER (trie-constrained
    generative retrieval over the item-code table), DenseT5 (encoder cosine
    retrieval) and SASRec (full-vocabulary ranking)."""
    from genrec_tpu_torch.backend.api import AppContext
    from genrec_tpu_torch.backend.config import Settings
    from genrec_tpu_torch.serving.recommend import (HybridRecommender, ItemCatalog,
                                                    make_env_llm_client)

    dev = resolve_device(args.device)
    recommender = catalog = None
    rec_h5 = os.path.join(args.data_dir, "recommendation_data.h5")
    emb_h5 = os.path.join(args.data_dir, "course_item_embs.h5")
    if os.path.exists(rec_h5) and os.path.exists(emb_h5):
        from genrec_tpu_torch.data.contracts import read_item_embs, read_recommendation_data
        classes, _, _ = read_recommendation_data(rec_h5)
        item_embs, _ = read_item_embs(emb_h5)
        catalog = ItemCatalog.from_recommendation_data(classes, item_embs)
        recommender = HybridRecommender(catalog=catalog, llm_client=make_env_llm_client())

    model_fn = None
    codes_npy = os.path.join(args.data_dir, "course", "course_rqvae_codes.npy")
    inter_h5 = os.path.join(args.data_dir, "user_item_interact.h5")
    if args.tiger_ckpt and os.path.exists(codes_npy):
        from genrec_tpu_torch.serving.model_fn import tiger_model_fn
        model_fn = tiger_model_fn(args.tiger_ckpt, codes_npy, device=dev)
    elif args.dense_t5_ckpt and os.path.exists(emb_h5):
        from genrec_tpu_torch.serving.model_fn import dense_t5_model_fn
        model_fn = dense_t5_model_fn(args.dense_t5_ckpt, emb_h5, device=dev)
    elif args.sasrec_ckpt and os.path.exists(inter_h5):
        from genrec_tpu_torch.serving.model_fn import sasrec_model_fn
        model_fn = sasrec_model_fn(args.sasrec_ckpt, inter_h5, device=dev)
    if (args.tiger_ckpt or args.dense_t5_ckpt or args.sasrec_ckpt) and model_fn is None:
        print("no best checkpoint found for the requested model; "
              "/recommend/model will 503", file=sys.stderr)

    settings = Settings.from_env()
    settings.host, settings.port = args.host, args.port
    if args.db:
        settings.database_path = args.db
    return AppContext.create(settings=settings, recommender=recommender,
                             catalog=catalog, model_recommend_fn=model_fn)


def _serve(args):
    """Start the education-app backend and the recommendation routes: the
    stdlib HTTP adapter, or FastAPI/uvicorn with ``--fastapi`` where they are
    installed."""
    from genrec_tpu_torch.backend.server import create_fastapi_app, serve

    ctx = make_context(args)
    if args.fastapi:
        import uvicorn
        uvicorn.run(create_fastapi_app(ctx), host=args.host, port=args.port)
    else:
        serve(ctx, host=args.host, port=args.port)


def _check_alignment(args):
    import pytest
    here = os.path.dirname(os.path.abspath(__file__))
    sys.exit(pytest.main([os.path.join(here, "..", "tests", "test_torch_alignment.py"), "-v",
                          "--noconftest", "-p", "no:cacheprovider"]))


def _init_db(args):
    from genrec_tpu_torch.backend import init_db
    init_db.main(["--db", args.db] +
                 (["--class-index", args.class_index] if args.class_index else []) +
                 (["--interactions", args.interactions] if args.interactions else []) +
                 (["--students", args.students] if args.students else []))


def _view_db(args):
    from genrec_tpu_torch.backend import view_db
    view_db.main(["--db", args.db] + (["--table", args.table] if args.table else []) +
                 ["-n", str(args.n)])


def _add_device(sp):
    sp.add_argument("--device", default=None,
                    help="torch device to run on (default: the card; 'cpu' for the CPU)")


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="genrec_tpu_torch")
    sub = p.add_subparsers(dest="cmd", required=True)

    sp = sub.add_parser("synth", help="generate a synthetic dataset")
    sp.add_argument("--out", default="data")
    sp.add_argument("--users", type=int, default=2000)
    sp.add_argument("--items", type=int, default=700)
    sp.add_argument("--max-len", type=int, default=40)
    sp.add_argument("--seed", type=int, default=0)
    sp.set_defaults(fn=_synth)

    for name, fn in [("sasrec", _sasrec), ("rqvae", _rqvae), ("tiger", _tiger),
                     ("tiger-prefix", _tiger_prefix), ("dense-t5", _dense_t5)]:
        sp = sub.add_parser(name, help=f"run the {name} pipeline")
        sp.add_argument("--data-dir", default="data")
        sp.add_argument("--ckpt-dir", default=f"ckpt/{name}")
        sp.add_argument("--epochs", type=int, default=None)
        _add_device(sp)
        if name in ("tiger", "tiger-prefix"):
            sp.add_argument("--constrained", default="level",
                            choices=["none", "level", "trie"])
        if name == "tiger":
            sp.add_argument("--len-buckets", type=int, default=1,
                            help="partition training by target length into N static-shape "
                                 "buckets; the port raises for N > 1 until the bucket "
                                 "modes are ported (ROADMAP Queue 1 item 5)")
        sp.set_defaults(fn=fn)

    sp = sub.add_parser("etl-app-db", help="SQLite app DB → H5 contracts")
    sp.add_argument("--db", required=True)
    sp.add_argument("--out", default="data")
    sp.set_defaults(fn=_etl_app_db)

    sp = sub.add_parser("etl-mooccube", help="MOOCCube course.json/user.json → H5 contracts")
    sp.add_argument("--courses", required=True, help="path to course.json")
    sp.add_argument("--users", required=True, help="path to user.json")
    sp.add_argument("--out", default="data")
    sp.set_defaults(fn=_etl_mooccube)

    sp = sub.add_parser("serve", help="start the app backend + rec routes")
    sp.add_argument("--data-dir", default="data")
    sp.add_argument("--db", default=None, help="app SQLite DB path")
    sp.add_argument("--host", default="127.0.0.1")
    sp.add_argument("--port", type=int, default=8000)
    sp.add_argument("--fastapi", action="store_true",
                    help="serve via FastAPI/uvicorn instead of stdlib")
    sp.add_argument("--sasrec-ckpt", default=None,
                    help="checkpoint dir of a trained SASRec (cli sasrec --ckpt-dir ...); "
                         "wires /api/v1/recommend/model to its best checkpoint")
    sp.add_argument("--tiger-ckpt", default=None,
                    help="checkpoint dir of a trained TIGER; wires /api/v1/recommend/model "
                         "to trie-constrained generative retrieval (takes precedence over "
                         "the other model flags)")
    sp.add_argument("--dense-t5-ckpt", default=None,
                    help="checkpoint dir of a trained DenseT5; wires "
                         "/api/v1/recommend/model to encoder cosine retrieval")
    _add_device(sp)
    sp.set_defaults(fn=_serve)

    sp = sub.add_parser("init-db", help="create + seed the app database")
    sp.add_argument("--db", default="app.db")
    sp.add_argument("--class-index")
    sp.add_argument("--interactions")
    sp.add_argument("--students")
    sp.set_defaults(fn=_init_db)

    sp = sub.add_parser("view-db", help="inspect the app database")
    sp.add_argument("--db", default="app.db")
    sp.add_argument("--table")
    sp.add_argument("-n", type=int, default=5)
    sp.set_defaults(fn=_view_db)

    sp = sub.add_parser("check-alignment", help="run data-contract invariants")
    sp.set_defaults(fn=_check_alignment)
    return p


def main(argv=None):
    args = build_parser().parse_args(argv)
    args.fn(args)


if __name__ == "__main__":
    main()
