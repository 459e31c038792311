"""Checkpoint / resume for long SDE solves (the counterpart of
``ccvm_tpu/checkpoint.py``).

The reference has no solver-state checkpointing: a crashed solve loses
everything.  Here a solve runs as segment launches of its kernel
(``ops.*_solve_segment``: the whole state, Adam's moments included, in and
out, from an absolute step) and the state snapshots to a ``.npz`` after each;
a restarted process resumes from the last snapshot.  The kernels key their
Philox counter and read their step table by the absolute step, so a resumed
solve equals an uninterrupted one bit for bit, on the card and on the CPU.

The file holds the JAX package's keys (``leaf_i`` arrays and a ``__meta__``
JSON with ``iteration`` and ``num_leaves``), so either package loads the
other's snapshots.
"""

from __future__ import annotations

import json
import os

import numpy as np
import torch


def _leaves(state):
    return list(state) if isinstance(state, (tuple, list)) else [state]


def save_state(path: str, state, iteration: int, meta: dict | None = None):
    """Snapshot a state (a tensor or a tuple of tensors) and its iteration
    counter to ``path`` (.npz).

    Atomic: writes to ``path + '.tmp'`` then renames, so a crash mid-write
    never corrupts the previous snapshot.
    """
    leaves = _leaves(state)
    payload = {f"leaf_{i}": np.asarray(torch.as_tensor(leaf).detach().cpu())
               for i, leaf in enumerate(leaves)}
    treedef = ("PyTreeDef(*)" if not isinstance(state, (tuple, list)) else
               "PyTreeDef((" + ", ".join("*" * len(leaves)) + "))")
    payload["__meta__"] = np.frombuffer(
        json.dumps(
            {
                "iteration": int(iteration),
                "num_leaves": len(leaves),
                "treedef": treedef,
                **(meta or {}),
            }
        ).encode("utf-8"),
        dtype=np.uint8,
    )
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        np.savez(f, **payload)
    os.replace(tmp, path)


def load_state(path: str, like=None):
    """Load a snapshot; returns ``(state, iteration, meta)``.

    ``like``: optional example state (a tensor or a tuple of tensors, e.g.
    the ``init_state`` of the solve): the state comes back in its structure
    and on its device.  Without it, the state is a tuple of CPU tensors, or
    one tensor if the snapshot holds one.
    """
    with np.load(path) as data:
        meta = json.loads(bytes(data["__meta__"]).decode("utf-8"))
        leaves = [torch.from_numpy(np.array(data[f"leaf_{i}"]))
                  for i in range(meta["num_leaves"])]
    if like is None:
        return (leaves[0] if len(leaves) == 1 else tuple(leaves)), meta["iteration"], meta
    like_leaves = _leaves(like)
    if len(like_leaves) != len(leaves):
        raise ValueError(f"{path} holds {len(leaves)} arrays, the state "
                         f"{len(like_leaves)}")
    leaves = [x.to(y.device) for x, y in zip(leaves, like_leaves)]
    state = tuple(leaves) if isinstance(like, (tuple, list)) else leaves[0]
    return state, meta["iteration"], meta


def _segment_state(out):
    """The state a segment function returns: the DL and MF segments return
    ``(state, readout)``, the Langevin family's the state alone (c, or
    Adam's (c, m, v))."""
    if isinstance(out, tuple) and isinstance(out[0], tuple):
        return out[0]
    return out


def checkpointed_solve(
    solve_segment,
    seed,
    q_matrix,
    v_vector,
    params,
    init_state,
    iterations: int,
    every: int,
    path: str,
    resume: bool = True,
    **flags,
):
    """Run a solve as segments of ``every`` steps with a snapshot after each.

    Args:
        solve_segment: one of ``ccvm_tpu_torch.ops.dl_kernels.dl_solve_segment``,
            ``mf_kernels.mf_solve_segment``,
            ``langevin_kernels.langevin_solve_segment`` or
            ``pumped_langevin_solve_segment``: the kernel's segment launch
            on "cuda" tensors, its plain version on "cpu" ones.
        seed: the solve's Philox seed (an int).
        init_state: the t=0 state as the segment function takes it, or None
            for the solve's own first state (zeros; MF's sigma start).
        iterations: total steps; every segment is a segment of a solve of
            this many steps (the DL, MF and pumped step tables depend on it).
        every: snapshot period (steps).
        path: snapshot file; overwritten atomically each period.
        resume: when True and ``path`` exists, continue from its iteration.
        **flags: forwarded to ``solve_segment``: ``batch_size`` (required),
            and ``pump_rate_flag``, ``pump_is_gt_one``, ``hp``,
            ``noise_scale``, ``rng`` as the function takes them.

    Returns:
        The final raw state (DL's c not clamped to +-S: the caller clamps, as
        after the JAX function), equal to an uninterrupted solve's.
    """
    start = 0
    state = init_state
    if resume and os.path.exists(path):
        state, start, _ = load_state(path, like=init_state)
        if init_state is None:
            on_device = [x.to(q_matrix.device) for x in _leaves(state)]
            state = tuple(on_device) if isinstance(state, tuple) else on_device[0]
    while start < iterations:
        num = min(every, iterations - start)
        state = _segment_state(solve_segment(
            seed, q_matrix, v_vector, params, state, start, num,
            iterations=iterations, **flags))
        start += num
        save_state(path, state, start)
    return state
