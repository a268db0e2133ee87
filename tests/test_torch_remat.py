"""Rematerialisation in the port's T5 (``remat``, ``attn_remat_dropout``,
``ffn_remat_dropout`` of ``T5ArchConfig``): the counterpart of the JAX
package's ``test_t5_remat_grads_match`` (``tests/test_models.py``).

Each flag, and all three together, changes memory and not math: TIGER at
``TIGERConfig()`` widths gives the plain module's loss within 1e-6 and every
gradient within 1e-5, in eval mode and in training mode at dropout 0.1 from
generators of the same seed (the recompute must draw the forward's masks
from the caller's generator, which ``torch.utils.checkpoint`` does not
replay), and the generator ends in the same state either way. Port
``remat=True`` equals JAX ``remat=True`` at deterministic (loss within 1e-5,
gradients within 5e-4, the bounds of ``test_torch_tiger_train.py``). With
``attn_remat_dropout``, no tensor of the attention mask's (H·B, Lq, Lk)
shape is saved for the backward.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from genrec_tpu.configs import TIGERConfig as JaxTIGERConfig
from genrec_tpu.models.tiger import TIGER as JaxTIGER
from genrec_tpu_torch import configs
from genrec_tpu_torch.convert import tiger_params_from_flax
from genrec_tpu_torch.models import dense_t5
from genrec_tpu_torch.models.tiger import TIGER

SEQ = configs.TIGERConfig().max_len * configs.TIGERConfig().code_dim
LT, BSZ = 12, 3
FLAGS = {"remat": dict(remat=True), "attn": dict(attn_remat_dropout=True),
         "ffn": dict(ffn_remat_dropout=True),
         "all": dict(remat=True, attn_remat_dropout=True, ffn_remat_dropout=True)}


def _inputs(bsz=BSZ, seed=0):
    r = np.random.default_rng(seed)
    ii = r.integers(1, 33, size=(bsz, SEQ))
    pad = r.integers(0, SEQ // 2, size=bsz)
    pad[0] = 0
    am = (np.arange(SEQ)[None, :] >= pad[:, None]).astype(np.int64)
    lab = r.integers(1, 33, size=(bsz, LT))
    lab[-1, LT // 2:] = -100
    return [torch.from_numpy(a) for a in (ii * am, am, lab)]


def _tiger(dropout, **flags):
    base = configs.TIGERConfig()
    cfg = dataclasses.replace(base, arch=dataclasses.replace(base.arch, dropout_rate=dropout,
                                                             **flags))
    return TIGER(cfg, generator=torch.Generator().manual_seed(0))


def _step(model, batch, generator):
    loss, _ = model(*batch, generator=generator)
    model.zero_grad()
    loss.backward()
    return loss.item(), {k: p.grad.clone() for k, p in model.named_parameters()}


@pytest.mark.parametrize("train", [False, True])
@pytest.mark.parametrize("flag", list(FLAGS))
def test_remat_flags_change_no_math(flag, train):
    batch = _inputs()
    plain, remat = _tiger(0.1), _tiger(0.1, **FLAGS[flag])
    remat.load_state_dict(plain.state_dict())
    for m in (plain, remat):
        m.train(train)
    gens = [torch.Generator().manual_seed(5) for _ in range(2)]
    loss0, grads0 = _step(plain, batch, gens[0])
    loss1, grads1 = _step(remat, batch, gens[1])
    assert abs(loss1 - loss0) <= 1e-6, (loss0, loss1)
    for k, g in grads0.items():
        err = float((grads1[k] - g).abs().max())
        assert err <= 1e-5, (flag, k, err)
    # the recompute put the generator back: both end where the forward left it
    assert torch.equal(gens[0].get_state(), gens[1].get_state())
    if train:  # the masks did draw: another seed gives another loss
        assert _step(remat, batch, torch.Generator().manual_seed(6))[0] != loss1


def test_remat_flags_on_the_encoder_only_stack():
    """DenseT5 (``T5Encoder``, f32 inputs_embeds) with all three flags at its
    dropout 0.3, in training mode: the plain module's loss and gradients."""
    def model(**flags):
        arch = configs.T5ArchConfig(d_model=32, num_layers=2, num_heads=2, d_kv=16, d_ff=64,
                                    dropout_rate=0.3, **flags)
        cfg = configs.DenseT5Config(arch=arch, input_emb_dim=32, target_emb_dim=32,
                                    max_seq_len=8)
        return dense_t5.DenseT5(cfg, torch.Generator().manual_seed(0)).train()

    r = np.random.default_rng(1)
    seq = torch.from_numpy(r.normal(size=(4, 9, 32)).astype(np.float32))
    mask = torch.from_numpy((np.arange(9)[None, :] <= np.array([8, 0, 3, 5])[:, None]))
    tgt = torch.from_numpy(r.normal(size=(4, 32)).astype(np.float32))
    out = []
    for flags in ({}, FLAGS["all"]):
        m = model(**flags)
        gen = torch.Generator().manual_seed(9)
        loss, _ = m(seq, mask.long(), tgt, generator=gen)
        loss.backward()
        out.append((loss.item(), {k: p.grad for k, p in m.named_parameters()},
                    gen.get_state()))
    (l0, g0, s0), (l1, g1, s1) = out
    assert abs(l1 - l0) <= 1e-6 and torch.equal(s0, s1)
    for k in g0:
        assert float((g1[k] - g0[k]).abs().max()) <= 1e-5, k


def test_port_remat_matches_jax_remat():
    """At one encoder and one decoder layer (the JAX compile dominates)."""
    base = JaxTIGERConfig()
    jc = dataclasses.replace(base, arch=dataclasses.replace(
        base.arch, remat=True, fused_attention="off", num_layers=1, num_decoder_layers=1))
    ii, am, lab = (np.asarray(t, np.int32) for t in _inputs())
    params = jax.jit(JaxTIGER(jc).init)(jax.random.PRNGKey(0), jnp.asarray(ii), jnp.asarray(am),
                               jnp.asarray(lab))
    params = jax.tree_util.tree_map(np.asarray, params)

    def loss_fn(p):
        return JaxTIGER(jc).apply(p, jnp.asarray(ii), jnp.asarray(am), jnp.asarray(lab),
                                  deterministic=True)[0]

    loss_j, grads_j = jax.jit(jax.value_and_grad(loss_fn))(params)
    model = _tiger(0.1, remat=True, num_layers=1, num_decoder_layers=1).eval()
    model.load_state_dict(tiger_params_from_flax(params, model.cfg), strict=True)
    want = tiger_params_from_flax(jax.tree_util.tree_map(np.asarray, grads_j),
                                  model.cfg)
    loss, grads = _step(model, _inputs(), None)
    assert abs(loss - float(loss_j)) < 1e-5
    for k, g in grads.items():
        err = float((g - want[k]).abs().max())
        assert err < 5e-4, (k, err)


def test_attn_remat_dropout_keeps_no_attention_mask():
    """A probe of the tensors saved for the backward: the plain module keeps
    each attention's (H·B, Lq, Lk) f32 dropout mask, the module with
    ``attn_remat_dropout`` keeps none (it draws them again in the backward)."""
    h = configs.TIGERConfig().arch.num_heads
    batch = _inputs()
    mask_shapes = {(h * BSZ, SEQ, SEQ), (h * BSZ, LT, LT), (h * BSZ, LT, SEQ)}

    def saved_mask_shapes(model):
        shapes = []

        def pack(t):
            shapes.append(tuple(t.shape))
            return t

        with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
            loss, _ = model(*batch, generator=torch.Generator().manual_seed(1))
        loss.backward()
        return {s for s in shapes if s in mask_shapes}

    plain, redraw = _tiger(0.1).train(), _tiger(0.1, attn_remat_dropout=True).train()
    assert saved_mask_shapes(plain) == mask_shapes
    assert saved_mask_shapes(redraw) == set()
