"""Sharded trainer: pjit train steps, grad accumulation, remat, eval.

Design:
* One compiled ``train_step`` over a ``Mesh`` — params sharded by the
  model family's ``param_sharding_rules`` (tensor parallel), batch
  sharded on the ``data`` axis; XLA inserts the gradient all-reduces
  from the sharding lattice (no hand-written collectives).
* Gradient accumulation is a ``lax.scan`` over microbatches inside the
  same compiled step (no per-microbatch dispatch).
* ``remat`` applies ``jax.checkpoint`` to the loss to trade FLOPs for
  HBM on long sequences.
* Params are kept in fp32 (master weights); compute dtype is whatever
  the model was built with (bf16 models need no loss scaling).
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Dict, Iterable, Optional, Tuple

import jax
import jax.numpy as jnp
import optax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..utils.logging import get_logger

logger = get_logger("training")


@dataclasses.dataclass
class TrainState:
    """Carried training state (a pytree)."""

    step: jax.Array
    params: Any
    opt_state: Any


jax.tree_util.register_pytree_node(
    TrainState,
    lambda s: ((s.step, s.params, s.opt_state), None),
    lambda _, c: TrainState(step=c[0], params=c[1], opt_state=c[2]),
)


def lm_loss(
    model_apply: Callable,
    params,
    batch: Dict[str, jax.Array],
    dropout_rng: Optional[jax.Array] = None,
) -> jax.Array:
    """Next-token cross entropy with an optional loss mask.

    ``dropout_rng`` switches the model to train mode (dropout active,
    incl. in-kernel attention-prob dropout) with that PRNG key.
    """
    if dropout_rng is not None:
        logits = model_apply(
            {"params": params},
            batch["input_ids"],
            deterministic=False,
            rngs={"dropout": dropout_rng},
        )
    else:
        logits = model_apply({"params": params}, batch["input_ids"])
    logp = jax.nn.log_softmax(logits.astype(jnp.float32), axis=-1)
    ll = jnp.take_along_axis(logp, batch["labels"][..., None], axis=-1)[..., 0]
    mask = batch.get("loss_mask")
    if mask is None:
        return -jnp.mean(ll)
    mask = mask.astype(jnp.float32)
    return -jnp.sum(ll * mask) / jnp.maximum(jnp.sum(mask), 1.0)


def make_train_step(
    model_apply: Callable,
    tx: optax.GradientTransformation,
    *,
    loss_fn: Optional[Callable] = None,
    accum_steps: int = 1,
    remat: bool = False,
    dropout_rng: Optional[jax.Array] = None,
):
    """Build a jittable ``(state, batch) -> (state, metrics)`` step.

    ``batch`` arrays have a leading microbatch axis when
    ``accum_steps > 1``: shape (accum, per_step_batch, ...).
    ``dropout_rng``: base PRNG key for train-mode dropout; each step
    folds in ``state.step`` (and the microbatch index) so every step
    draws fresh masks. None = eval-mode forward (no dropout).
    """
    base_loss = loss_fn or lm_loss

    if dropout_rng is not None:
        plain = lambda params, micro, key: base_loss(  # noqa: E731
            model_apply, params, micro, dropout_rng=key
        )
    else:
        plain = lambda params, micro, key: base_loss(  # noqa: E731
            model_apply, params, micro
        )
    one_loss = jax.checkpoint(plain) if remat else plain

    def step(state: TrainState, batch: Dict[str, jax.Array]):
        step_key = (
            jax.random.fold_in(dropout_rng, state.step)
            if dropout_rng is not None
            else None
        )
        if accum_steps == 1:
            loss, grads = jax.value_and_grad(one_loss)(
                state.params, batch, step_key
            )
        else:
            def accum(carry, xs):
                micro, idx = xs
                loss_acc, grads_acc = carry
                key = (
                    jax.random.fold_in(step_key, idx)
                    if step_key is not None
                    else None
                )
                loss, grads = jax.value_and_grad(one_loss)(
                    state.params, micro, key
                )
                grads_acc = jax.tree_util.tree_map(jnp.add, grads_acc, grads)
                return (loss_acc + loss, grads_acc), None

            zeros = jax.tree_util.tree_map(
                lambda p: jnp.zeros(p.shape, jnp.float32), state.params
            )
            n_micro = jax.tree_util.tree_leaves(batch)[0].shape[0]
            (loss, grads), _ = jax.lax.scan(
                accum,
                (jnp.float32(0), zeros),
                (batch, jnp.arange(n_micro, dtype=jnp.int32)),
            )
            loss = loss / accum_steps
            grads = jax.tree_util.tree_map(lambda g: g / accum_steps, grads)

        updates, opt_state = tx.update(grads, state.opt_state, state.params)
        params = optax.apply_updates(state.params, updates)
        gnorm = optax.global_norm(grads)
        new_state = TrainState(
            step=state.step + 1, params=params, opt_state=opt_state
        )
        return new_state, {"loss": loss, "grad_norm": gnorm}

    return step


class Trainer:
    """Mesh-sharded training loop with metrics and checkpoint hooks.

    Args:
      model: a model with ``init``/``apply`` (``models.functional``).
      tx: optax transformation.
      mesh: optional ``Mesh``; when given, params are placed by
        ``param_specs`` (a PartitionSpec tree, e.g. from
        ``models.param_sharding_rules``) and batches by
        ``P(data_axis, ...)``.
    """

    def __init__(
        self,
        model,
        tx: optax.GradientTransformation,
        *,
        mesh: Optional[Mesh] = None,
        param_specs: Any = None,
        data_axis: str = "data",
        accum_steps: int = 1,
        remat: bool = False,
        loss_fn: Optional[Callable] = None,
    ) -> None:
        self.model = model
        self.tx = tx
        self.mesh = mesh
        self.param_specs = param_specs
        self.data_axis = data_axis
        self.accum_steps = accum_steps
        self._step_fn = jax.jit(
            make_train_step(
                model.apply, tx, accum_steps=accum_steps, remat=remat,
                loss_fn=loss_fn,
            )
        )
        self.history: list = []

    # -- state management ---------------------------------------------------

    def init_state(self, rng, sample_batch: Dict[str, jax.Array]) -> TrainState:
        sample = sample_batch["input_ids"]
        if self.accum_steps > 1:
            sample = sample[0]
        variables = self.model.init(rng, sample[:1, :8])
        params = variables["params"]
        if self.mesh is not None and self.param_specs is not None:
            shardings = jax.tree_util.tree_map(
                lambda s: NamedSharding(self.mesh, s), self.param_specs
            )
            params = jax.device_put(params, shardings)
        opt_state = jax.jit(self.tx.init)(params)
        return TrainState(step=jnp.int32(0), params=params, opt_state=opt_state)

    def _place_batch(self, batch: Dict[str, jax.Array]) -> Dict[str, jax.Array]:
        if self.mesh is None:
            return batch
        def put(x):
            spec = P(*([None] if self.accum_steps > 1 else []) + [self.data_axis]
                     + [None] * (x.ndim - (2 if self.accum_steps > 1 else 1)))
            return jax.device_put(x, NamedSharding(self.mesh, spec))
        return {k: put(jnp.asarray(v)) for k, v in batch.items()}

    # -- loops ---------------------------------------------------------------

    def train_step(self, state: TrainState, batch) -> Tuple[TrainState, Dict]:
        batch = self._place_batch(batch)
        if self.mesh is not None:
            with self.mesh:
                state, metrics = self._step_fn(state, batch)
        else:
            state, metrics = self._step_fn(state, batch)
        return state, metrics

    def fit(
        self,
        state: TrainState,
        batches: Iterable[Dict[str, jax.Array]],
        *,
        steps: Optional[int] = None,
        log_every: int = 10,
        checkpoint_fn: Optional[Callable[[TrainState, int], None]] = None,
        checkpoint_every: int = 0,
    ) -> TrainState:
        t0 = time.time()
        for i, batch in enumerate(batches):
            if steps is not None and i >= steps:
                break
            state, metrics = self.train_step(state, batch)
            if (i + 1) % log_every == 0:
                loss = float(metrics["loss"])
                self.history.append({"step": int(state.step), "loss": loss})
                logger.info(
                    "step %d loss %.4f grad_norm %.3f (%.2f s)",
                    int(state.step), loss, float(metrics["grad_norm"]),
                    time.time() - t0,
                )
            if checkpoint_fn and checkpoint_every and (i + 1) % checkpoint_every == 0:
                checkpoint_fn(state, int(state.step))
        return state

    def evaluate(
        self, state: TrainState, batches: Iterable[Dict[str, jax.Array]],
        loss_fn: Optional[Callable] = None,
    ) -> float:
        fn = loss_fn or lm_loss
        eval_loss = jax.jit(lambda p, b: fn(self.model.apply, p, b))
        total, n = 0.0, 0
        for batch in batches:
            batch = {k: jnp.asarray(v) for k, v in batch.items()}
            total += float(eval_loss(state.params, batch))
            n += 1
        return total / max(n, 1)
