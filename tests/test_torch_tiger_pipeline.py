"""The port's TIGER pipeline end to end on the CPU at a tiny size, mirroring
the JAX package's tests/test_pipelines.py: it trains with dropout 0.1 and
learns, evaluates with trie-constrained beams and writes the results CSV;
the device-resident eval equals the streaming ``beam_evaluate``; a resumed
run continues at the next epoch; ``main`` reads the split and code files.
The dropout streams differ from JAX's, so parity here is the metric keys
and the model learning, as in the reference's own test.
"""

import dataclasses

import numpy as np
import pytest
import torch

from genrec_tpu_torch import configs
from genrec_tpu_torch.data import contracts, datasets, synthetic, tiger_tokens
from genrec_tpu_torch.eval.evaluator import beam_evaluate
from genrec_tpu_torch.models.tiger import TIGER, generate, make_constraint
from genrec_tpu_torch.pipelines import tiger_pipeline


@pytest.fixture(scope="module")
def tiger_data():
    corpus = synthetic.make_interactions(num_users=300, num_items=60, min_len=4,
                                         max_len=15, num_topics=6,
                                         topic_stickiness=0.95, seed=7)
    codes = synthetic.make_codes(num_items=60, codebook_size=8, num_levels=3, seed=5)
    train_split, test_split = tiger_tokens.build_tiger_splits(
        corpus.item_id_lists, corpus.user_ids, codes)
    return codes, train_split, test_split


def _cfg(tmp_path, dropout, constrained, **kw):
    arch = configs.T5ArchConfig(vocab_size=64, num_layers=1, num_decoder_layers=1,
                                d_model=32, d_ff=64, num_heads=2, d_kv=16,
                                dropout_rate=dropout)
    base = dict(epochs=4, batch_size=64, eval_batch_size=64, lr=3e-3,
                ckpt_dir=str(tmp_path / "ckpt"), early_stop_patience=10, seed=0)
    base.update(kw)
    return configs.TIGERConfig(arch=arch, max_len=8, beam_size=5, topk_list=(1, 5),
                               constrained_decoding=constrained,
                               trainer=configs.TrainerConfig(**base))


def _arrays(cfg, split, test=False):
    return datasets.build_tiger_arrays(split, cfg.max_len, cfg.code_dim,
                                       max_target_items=1 if test else None)


def test_tiger_end_to_end(tmp_path, tiger_data):
    codes, train_split, test_split = tiger_data
    cfg = _cfg(tmp_path, 0.1, "trie", results_csv_path=str(tmp_path / "tiger.csv"))
    te = _arrays(cfg, test_split, test=True)
    art = tiger_pipeline.train(cfg, _arrays(cfg, train_split), te, device="cpu")
    assert art.result.train_losses[-1] < art.result.train_losses[0]
    metrics = tiger_pipeline.evaluate(cfg, art, te, codes=codes[1:], device="cpu")
    assert set(metrics) == {"Recall@1", "Recall@5", "NDCG@1", "NDCG@5"}
    assert metrics["Recall@5"] >= metrics["Recall@1"]
    assert metrics["Recall@5"] > 0.0
    assert (tmp_path / "tiger.csv").exists()


def test_tiger_device_resident_eval_matches_streaming(tmp_path, tiger_data):
    codes, train_split, test_split = tiger_data
    cfg = _cfg(tmp_path, 0.0, "level", epochs=1)
    te = _arrays(cfg, test_split, test=True)
    art = tiger_pipeline.train(cfg, _arrays(cfg, train_split), te, device="cpu")
    fused = tiger_pipeline.evaluate(cfg, art, te, device="cpu")

    model = TIGER(cfg)
    model.load_state_dict(art.params)
    model.eval()
    constraint = make_constraint(cfg)

    def generate_fn(batch, num_beams):
        toks, _ = generate(model, torch.from_numpy(batch["input_ids"]),
                           torch.from_numpy(batch["attention_mask"]), num_beams=num_beams,
                           constraint=constraint)
        return toks

    # the device-resident path takes the global mean over the valid rows
    streaming = beam_evaluate(generate_fn, datasets.iterate_batches(
        te.arrays, cfg.trainer.eval_batch_size, shuffle=False), cfg.topk_list, cfg.beam_size,
        batch_mean=False)
    for k in streaming:
        assert abs(streaming[k] - fused[k]) < 1e-6, (k, streaming, fused)


def test_tiger_resume_and_main(tmp_path, tiger_data):
    """Resume mirrors the reference's test_sasrec_resume; ``main`` reads the
    split and code files named by the config."""
    codes, train_split, test_split = tiger_data
    cfg = _cfg(tmp_path, 0.1, "trie", epochs=2)
    paths = {k: str(tmp_path / "data" / f"{k}.h5") for k in ("train", "test")}
    contracts.write_tiger_split(paths["train"], train_split)
    contracts.write_tiger_split(paths["test"], test_split)
    code_path = str(tmp_path / "data" / "codes.npy")
    contracts.write_codes(code_path, codes[1:])
    cfg = dataclasses.replace(cfg, train_dataset_path=paths["train"],
                              test_dataset_path=paths["test"], code_path=code_path)
    metrics = tiger_pipeline.main(cfg, device="cpu")
    assert set(metrics) == {"Recall@1", "Recall@5", "NDCG@1", "NDCG@5"}

    cfg2 = dataclasses.replace(cfg, trainer=dataclasses.replace(
        cfg.trainer, epochs=3, resume=True))
    art2 = tiger_pipeline.train(cfg2, device="cpu")
    assert len(art2.result.train_losses) == 1
    assert art2.result.epochs_run == 3
    assert np.isfinite(art2.result.train_losses[0])


def test_bucket_modes_raise_where_they_would_train_flat(tmp_path, tiger_data):
    """The reference trains by target-length buckets or composite widths when
    either field asks for it (`genrec_tpu/pipelines/tiger_pipeline.py:86-92`);
    the port has neither mode yet, so it refuses both before it reads or
    trains anything, and so does the CLI's ``tiger --len-buckets 4``."""
    from genrec_tpu_torch import cli

    _, train_split, test_split = tiger_data
    base = _cfg(tmp_path, 0.0, "none")
    tr, te = _arrays(base, train_split), _arrays(base, test_split, test=True)
    for field, value in (("target_len_buckets", 4), ("target_len_composite", 2)):
        cfg = dataclasses.replace(base, **{field: value})
        with pytest.raises(ValueError, match="Queue 1 item 5"):
            tiger_pipeline.train(cfg, tr, te, device="cpu")
        with pytest.raises(ValueError, match="Queue 1 item 5"):
            tiger_pipeline.build_trainer(cfg, tr, te, device="cpu")
    ckpt = tmp_path / "cli_ckpt"
    with pytest.raises(ValueError, match="Queue 1 item 5"):
        cli.main(["tiger", "--len-buckets", "4", "--device", "cpu", "--epochs", "1",
                  "--data-dir", str(tmp_path / "absent"), "--ckpt-dir", str(ckpt)])
    assert not ckpt.exists()
