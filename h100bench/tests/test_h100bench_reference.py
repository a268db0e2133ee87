"""The plain reference against the port's CPU path at small sizes: the same
weights, inputs and dropout generator give the same losses, gradients,
beams and scores."""

import numpy as np
import torch

from h100bench import cell as cells, check, corpus
from h100bench.runners import program_config, program_model
from h100bench.reference import model as ref


def _prefix_batch(cfg, t, seed, n=6):
    arrays, _ = corpus.train_arrays(seed, cfg, dict(t, students=n))
    arrays.update(corpus.prof_vectors(seed, cfg, n, "cpu"))
    b = {k: torch.as_tensor(v) for k, v in arrays.items()}
    b["valid"] = torch.tensor([True] * (n - 1) + [False])
    return b


def test_training_loss_and_gradients_equal_the_port_with_dropout():
    from genrec_tpu_torch.pipelines.tiger_prefix_pipeline import loss_fn

    c = cells.find_cell("tiger_prefix.train_b1024")
    cfg = c.config
    weights = corpus.make_weights(4, ref.param_spec(cfg), "cpu")
    model = program_model(cfg, program_config(cfg, 6, ""), weights, "cpu").train()
    batch = _prefix_batch(cfg, c.traffic, 4)
    loss, _ = loss_fn(model, batch, torch.Generator().manual_seed(9))
    loss.backward()
    leaves = {k: v.clone().requires_grad_(True) for k, v in weights.items()}
    rl = ref.loss(ref.Precision(), cfg, leaves, batch,
                  ref.Draws(torch.Generator().manual_seed(9), cfg["arch"]["dropout_rate"]))
    rl.backward()
    assert abs(float(loss.detach()) - float(rl.detach())) <= 1e-6 * abs(float(rl.detach()))
    # a key's bias under softmax has a gradient of rounding alone: the scale
    # of the comparison is the median leaf's
    scale = float(torch.tensor([float(v.grad.abs().max()) for v in leaves.values()]).median())
    for k, p in model.named_parameters():
        g, r = p.grad, leaves[k].grad
        assert torch.allclose(g, r, rtol=1e-4, atol=1e-5 * scale), k


def test_adam_steps_equal_the_ports_optimizer():
    from genrec_tpu_torch.train.optim import make_optimizer

    c = cells.find_cell("tiger_prefix.train_b1024")
    cfg = dict(c.config, arch=dict(c.config["arch"], dropout_rate=0.0))
    weights = corpus.make_weights(5, ref.param_spec(cfg), "cpu")
    pcfg = program_config(cfg, 6, "")
    model = program_model(cfg, pcfg, weights, "cpu").train()
    opt = make_optimizer(model.parameters(), pcfg.trainer)
    batches = [_prefix_batch(cfg, c.traffic, s) for s in (1, 2)]
    from genrec_tpu_torch.pipelines.tiger_prefix_pipeline import loss_fn

    for b in batches:
        opt.zero_grad()
        loss_fn(model, b, None)[0].backward()
        opt.step()
    out = ref.train_steps(cfg, weights, batches, torch.Generator())
    # Adam moves an element whose gradient is near its eps by rounding of
    # that gradient: compare each leaf's change by its norm, as the check does
    prog = {k: p.detach() - weights[k] for k, p in model.named_parameters()}
    want = {k: out["params"][k] - weights[k] for k in prog}
    gaps = check.leaf_gaps(prog, want, out["grads"])
    assert max(gaps.values()) < 1e-3, gaps


def test_beam_search_and_scores_equal_the_ports_generate():
    from genrec_tpu_torch.models.tiger import generate, make_constraint

    c = cells.find_cell("tiger.recommend_b4096")
    cfg = c.config
    hist, codes = corpus.serving_histories(6, cfg, dict(c.traffic, pool=10))
    weights = corpus.make_weights(6, ref.param_spec(cfg), "cpu")
    pcfg = program_config(cfg, 10, "")
    model = program_model(cfg, pcfg, weights, "cpu").eval()
    batch = {k: torch.as_tensor(v) for k, v in hist.items()}
    toks, scores = generate(model, batch["input_ids"], batch["attention_mask"], num_beams=20,
                            constraint=make_constraint(pcfg, codes[1:]))
    trie = ref.trie_tables(codes[1:], cfg["arch"]["vocab_size"], cfg["codebook_size"], "cpu")
    rt, rs = ref.beam_search(cfg, weights, batch, 20, trie)
    assert torch.equal(toks, rt)
    assert torch.allclose(scores, rs, atol=1e-5)
    again = ref.sequence_scores(cfg, weights, batch, toks, trie)
    assert torch.allclose(again, scores, atol=1e-5)
    # every returned sequence is an item of the catalog
    items = {tuple(r) for r in (codes[1:] + np.arange(4) * 8 + 1).tolist()}
    assert all(tuple(s[1:]) in items for s in toks.reshape(-1, 5).tolist())


def test_tf32_rounding():
    x = torch.tensor([1.0, 1.0 + 2 ** -11, 1.0 + 2 ** -10 + 2 ** -12, -3.0000001])
    r = ref.round_tf32(x)
    assert r.tolist() == [1.0, 1.0 + 2 ** -10, 1.0 + 2 ** -10, -3.0]
    y = torch.randn(1000)
    assert float(((ref.round_tf32(y) - y).abs() / y.abs()).max()) <= 2 ** -11
