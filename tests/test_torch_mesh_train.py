"""Data-parallel training over the port's (data, band) mesh against the JAX
package's sharded training, on the CPU.

Four gloo ranks (``torch_mesh_ranks.train_ranks``: spawned once for this
module, joined within 120 s) train on a (2, 2) ``DeviceMesh("cpu")``; JAX
trains here on a (2, 2) ``Mesh`` of conftest's virtual CPU devices, the
batch sharded over both axes as its ``make_train_step(mesh=)`` does. The
tolerances are the JAX package's own sharded-vs-unsharded test's (1e-6)
for one step, and ``tests/test_torch_training.py``'s float32 run
tolerances (losses rtol 1e-3, the bank within one lr) for a short
fine-tune.
"""

import jax
import numpy as np
import pytest

from torch_mesh_ranks import Ranks, signal, train_ranks

FINETUNE = dict(steps=6, batch=4, length=1024, lr=3e-5)


def _jax_mesh():
    from jax.sharding import Mesh

    return Mesh(np.asarray(jax.devices()[:4]).reshape(2, 2),
                ("data", "band"))


def _jax_refs() -> dict:
    import jax.numpy as jnp

    from pqmf_tpu.ops import filterbank as jfb
    from pqmf_tpu.parallel import training as jt

    hk = jnp.asarray(jfb.build_filterbank(70, 4)["hk"])
    x = signal(2, (8, 1, 256))
    init_s, step_s = jt.make_train_step(mesh=_jax_mesh())
    ss, loss = step_s(init_s(hk), x)
    params, losses = jt.finetune_filterbank(70, 8, mesh=_jax_mesh(),
                                            **FINETUNE)
    return {"step_loss": float(loss), "step_hk": np.asarray(ss.hk),
            "finetune_hk": np.asarray(params["hk"]),
            "finetune_losses": np.asarray(losses)}


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    ranks = Ranks(train_ranks, tmp_path_factory.mktemp("train"))
    try:
        ref = _jax_refs()
    finally:
        out = ranks.join()
    return out, ref


def test_train_step_grads_match_jax_sharded(run):
    """One data-parallel step on a (2, 2) world of 4 against JAX's sharded
    step: loss and hk within 1e-6."""
    out, ref = run
    assert abs(float(out[0]["step_loss"]) - ref["step_loss"]) < 1e-6
    np.testing.assert_allclose(out[0]["step_hk"], ref["step_hk"],
                               atol=1e-6, rtol=1e-6)


def test_train_step_grads_match_unsharded(run):
    """The sharded step equals the port's single-device step (the same
    update math), as the JAX package's test of the same name holds."""
    res = run[0][0]
    assert abs(float(res["step_loss"]) - float(res["step_loss_port"])) < 1e-6
    np.testing.assert_allclose(res["step_hk"], res["step_hk_port"],
                               atol=1e-6, rtol=1e-6)


def test_params_stay_replicated_on_every_rank(run):
    """Every rank all-reduces the same mean gradient and takes the same
    Adam step: hk, the losses and the fine-tuned bank are bit-equal on
    all four."""
    out = run[0]
    for r in range(1, len(out)):
        for k in ("step_loss", "step_hk", "trainable_losses", "finetune_hk",
                  "finetune_losses"):
            np.testing.assert_array_equal(out[r][k], out[0][k], err_msg=k)


def test_eager_step_equals_the_step(run):
    res = run[0][0]
    np.testing.assert_array_equal(res["eager_hk"], res["step_hk"])


def test_sharded_trainable_pqmf_reduces_loss(run):
    losses = run[0][0]["trainable_losses"]
    assert np.isfinite(losses).all()
    assert losses[-1] < losses[0]


def test_sharded_finetune_matches_jax(run):
    out, ref = run
    np.testing.assert_allclose(out[0]["finetune_losses"],
                               ref["finetune_losses"], rtol=1e-3)
    np.testing.assert_allclose(out[0]["finetune_hk"], ref["finetune_hk"],
                               rtol=0, atol=FINETUNE["lr"])


def test_uneven_batch_raises_as_jax(run):
    """A batch of 6 does not split over 4 devices: JAX's sharded step
    raises ValueError, and so does the port's."""
    import jax.numpy as jnp

    from pqmf_tpu.ops import filterbank as jfb
    from pqmf_tpu.parallel import training as jt

    init_s, step_s = jt.make_train_step(mesh=_jax_mesh())
    with pytest.raises(ValueError, match="divisible by 4"):
        step_s(init_s(jnp.asarray(jfb.build_filterbank(70, 4)["hk"])),
               signal(2, (6, 1, 256)))
    for res in run[0]:
        assert "divisible by 4" in str(res["uneven"]), res["uneven"]
