"""One training step of the port against the JAX package's, as in
tests/test_torch_train_step.py (float64 both sides, the same seeded
weights and batch, within 1e-9·max(1, |ref|)), for the other decoder
families and the other steps: a hybrid step of Linknet (the JAX side
through its train s2d tail, the port through its native decoder) and of
FPN, the SSR trainer's seg step (focal + dice, class weights) and the
patch trainer's cls step (``YNet.classify``)."""

import numpy as np
import pytest

from test_torch_train_step import (CW, REL, SW, TILE, assert_step_close,
                                   configs, hybrid_batch, run_pair)


@pytest.mark.parametrize("family,tail", [("Linknet", True),
                                         ("FPN", False)])
def test_family_hybrid_step_matches_jax(family, tail):
    jcfg, tcfg = configs(model_name=family, train_s2d_tail=tail)
    out = run_pair("hybrid", jcfg, tcfg, hybrid_batch(), cls_weights=CW,
                   seg_weights=SW)
    assert assert_step_close(*out) <= REL


def test_seg_step_matches_jax():
    """train_ssr's step: focal on the decoder's logits plus dice."""
    jcfg, tcfg = configs(loss="focal")
    r = np.random.RandomState(4)
    batch = {"image": r.randn(4, TILE, TILE, 3),
             "seg_label": r.randint(0, 4, (4, TILE, TILE)).astype(np.int32)}
    out = run_pair("seg", jcfg, tcfg, batch, with_dice=True,
                   class_weights=SW)
    assert assert_step_close(*out) <= REL


def test_cls_step_matches_jax():
    """train_p's step: encoder → classifier, masked xent and accuracy."""
    jcfg, tcfg = configs(loss="xent")
    r = np.random.RandomState(5)
    batch = {"image": r.randn(4, TILE, TILE, 3),
             "cls_label": np.array([1, 3, -1, 0], np.int32),
             "is_cls": np.array([1.0, 1.0, 0.0, 1.0])}
    out = run_pair("cls", jcfg, tcfg, batch, class_weights=CW)
    assert assert_step_close(*out) <= REL
