"""BoxQP problem instances on PyTorch tensors.

Functional parity with the reference loader/evaluator
(``ccvm_simulators/problem_classes/boxqp/problem_instance.py``) and with
``ccvm_tpu/problem_classes/boxqp/problem_instance.py``:

* ``.in`` file format: header line ``size, optimal_sol, best_sol, optimality,
  sol_time_gb, sol_time_bfgs, seed, num_frac_values`` (``:154-172``), then the
  V vector, then N rows of Q, then an optional trailing solution vector
  (``:190-201``).
* Both V and Q are **negated** on load (``:181-188``): files store a
  maximization problem, solvers minimize, and ``Solution`` flips the sign
  back.
* ``compute_energy`` = ``(0.5 x Q x + V x) * scaled_by`` (``:226-241``).
* ``scale_coefs`` divides Q and V and multiplies ``scaled_by`` so consecutive
  scalings stack (``:243-255``).

Parsing happens once on the host into NumPy float64; Q and V then live on the
requested device in float32, and float32 products run with TF32 off.
"""

from __future__ import annotations

import enum

import numpy as np
import torch

from ccvm_tpu_torch import profiling
from ccvm_tpu_torch.native import fast_parse_matrix, load_library
from ccvm_tpu_torch.runtime import fp32_matmul, put, validate_device


class InstanceType(enum.Enum):
    """Enumerate instance types (reference ``problem_instance.py:12-17``)."""

    TUNING = "tuning"
    TEST = "test"


def _energy(confs, q_matrix, v_vector, scaled_by):
    """Batched BoxQP objective 0.5 xQx + Vx, scaled, in IEEE float32 (the
    readout's rounding bound assumes true float32 products).  Over an
    instance axis: (I, B, n) confs, (I, n, n) Q, (I, n) V and an (I, 1)
    tensor ``scaled_by``."""
    with fp32_matmul():
        qx = torch.matmul(confs, q_matrix)
        energy1 = torch.sum(confs * qx, dim=-1) * scaled_by
        if v_vector.ndim == 2:  # a batched matvec: V as (I, n, 1)
            energy2 = torch.matmul(confs, v_vector[..., None])[..., 0] * scaled_by
        else:
            energy2 = torch.matmul(confs, v_vector) * scaled_by
    return 0.5 * energy1 + energy2


def _energy_and_bound(confs, q_matrix, v_vector, scaled_by):
    """(2, batch), or (2, I, B) over an instance axis: f32 energies and
    their abs-value rounding-bound inputs (see
    :func:`ambiguous_readout_rows`)."""
    e = _energy(confs, q_matrix, v_vector, scaled_by)
    a = _energy(torch.abs(confs), torch.abs(q_matrix), torch.abs(v_vector),
                abs(scaled_by))
    return torch.stack([e, a])


@profiling.annotate("ccvm.readout")
def stacked_readout64(instances, confs, q_matrices, v_vectors):
    """float64-grade readout of a stacked sweep
    (``ccvm_tpu/parallel/sweep.py:84-151``): (I, batch) float64 energies
    whose every ``Solution`` statistic equals the full-float64 path's, as
    :meth:`ProblemInstance.compute_energy_readout64` guarantees for one
    instance.  ``confs`` (I, batch, n) lie on the device with the stacked
    (I, n, n) Q and (I, n) V; the f32 energies and bounds of every instance
    cross in one (2, I, batch) copy, and the rows a float32 pass cannot
    classify, gathered over all instances, in one more."""
    num_instances, batch, n = confs.shape
    scales = torch.tensor([float(np.float32(inst.scaled_by)) for inst in instances],
                          dtype=torch.float32, device=confs.device)[:, None]
    both = _energy_and_bound(confs, q_matrices, v_vectors, scales)
    profiling.count("host_syncs")
    both = both.cpu().numpy().astype(np.float64)
    e_all, abs_all = both[0], both[1]
    per_instance = []
    for i, inst in enumerate(instances):
        if inst.optimal_sol is None:
            per_instance.append(np.arange(batch))
        else:
            per_instance.append(np.flatnonzero(ambiguous_readout_rows(
                e_all[i], inst.optimal_sol, n, abs_e=abs_all[i])))
    flat = np.concatenate([idx + i * batch for i, idx in enumerate(per_instance)])
    if flat.size:
        profiling.count("host_syncs")
        rows = confs.reshape(num_instances * batch, n)[
            torch.as_tensor(flat, device=confs.device)].cpu().numpy()
        off = 0
        for i, inst in enumerate(instances):
            idx = per_instance[i]
            if idx.size:
                e_all[i, idx] = inst.compute_energy_host64(rows[off:off + idx.size])
                # Kept-f32 rows clamped to the recomputed best, as
                # compute_energy_readout64 does.
                e_all[i] = np.maximum(e_all[i], e_all[i, idx].min())
            off += idx.size
    return e_all


def _apply_cv(pv, cv_mode, lo, hi, S):
    """Change of variables applied inside the readout; the expressions
    match :func:`ccvm_tpu_torch.dynamics.common.change_variables_boxqp`
    ("boxqp", the DL solver's) and
    :func:`ccvm_tpu_torch.dynamics.common.langevin_change_variables`
    ("langevin", which hardcodes the [0, 1] box and ignores lo and hi)."""
    if cv_mode == "boxqp":
        return 0.5 * pv / S * (hi - lo) + 0.5 * (hi + lo)
    if cv_mode == "langevin":
        return (pv + S) / (2 * S)
    raise ValueError(f"unknown change-of-variables mode {cv_mode!r}")


def ambiguous_readout_rows(e, opt, n, abs_e=None, gap_margin=None, top_k=64):
    """Bool mask of rows a float32 energy pass cannot safely classify.

    ``e`` is the float32-computed (widened) minimization energy vector; a row
    is ambiguous when its optimality gap sits within the rounding margin of
    any gap threshold, its |energy| is too small for a well-conditioned
    relative gap, its gap is non-finite, or it is among the ``top_k`` best
    rows (exact best value / argmax).

    ``abs_e`` (the device-evaluated absolute-value energy) activates the
    rigorous per-row bound |fl(e) − e| ≤ γₙ·abs_e; otherwise the fixed
    ``gap_margin`` (in gap percentage points) applies.
    """
    pos = -e  # Solution's positive-objective convention
    with np.errstate(divide="ignore", invalid="ignore"):
        gap = (opt - pos) * 100.0 / np.abs(pos)
        if abs_e is not None:
            # gamma_n with headroom for coefficient-storage rounding, the
            # scaled_by multiply, reduction order, and multi-pass matmul
            # modes.
            gamma = 16.0 * (n + 8) * 2.0 ** -23
            de = gamma * np.asarray(abs_e, np.float64) + 1e-12
            dgap = 100.0 * (abs(opt) + 2.0 * np.abs(pos)) / (pos * pos) * de
        else:
            dgap = float(gap_margin)
        thr = np.array([0.1, 1.0, 2.0, 3.0, 4.0, 5.0, 10.0])
        dist = np.abs(gap[:, None] - thr[None, :]).min(axis=1)
        near = dist < dgap
    near |= np.abs(pos) < 1e-3 * max(abs(opt), 1.0)
    near |= ~np.isfinite(gap)
    k = min(int(top_k), e.shape[0])
    if k:
        near[np.argpartition(e, k - 1)[:k]] = True
    return near


@profiling.annotate("ccvm.parse")
def parse_instance_file(file_path: str, file_delimiter: str = "\t"):
    """Parse a ``.in`` file into host NumPy arrays + metadata dict.

    Sign conventions match the reference loader exactly (V and Q negated).
    The body (V and Q) goes through the native tokenizer
    (:func:`ccvm_tpu_torch.native.fast_parse_matrix`), the header and the
    solution line through Python; a malformed file raises "Error reading
    instance file", and a library that cannot be built raises its own
    ``RuntimeError``.
    """
    load_library()
    with open(file_path, "r") as stream:
        lines = stream.readlines()

    try:
        instance_info = lines[0].rstrip("\n").split(file_delimiter)
        problem_size = int(instance_info[0])
        meta = {
            "problem_size": problem_size,
            "optimal_sol": float(instance_info[1]),
            "best_sol": float(instance_info[2]),
            "optimality": instance_info[3].lower() == "true",
            "sol_time_gb": float(instance_info[4]),
            "sol_time_bfgs": float(instance_info[5]),
            # seed = instance_info[6] is discarded, as in the reference (:172)
            "num_frac_values": int(instance_info[7]),
        }
        body = fast_parse_matrix(
            lines[1 : problem_size + 2], file_delimiter, problem_size
        )
        v_vector = -body[0, :]
        q_matrix = -body[1:, :]

        solution_vector = []
        if len(lines) > problem_size + 2:
            for tok in lines[problem_size + 2].rstrip("\n").split(file_delimiter):
                if tok != "":
                    solution_vector.append(float(tok))
    except Exception as e:  # match the reference's blanket error (:203-204)
        raise Exception("Error reading instance file: " + str(e))

    return (
        q_matrix.astype(np.float64),
        v_vector.astype(np.float64),
        solution_vector,
        meta,
    )


class ProblemInstance:
    """Defines a BoxQP problem instance (reference ``problem_instance.py:20``).

    ``device`` defaults to "cuda"; pass "cpu" for the plain PyTorch path.
    """

    def __init__(
        self,
        device="cuda",
        instance_type="tuning",
        file_path=None,
        file_delimiter="\t",
        name=None,
        solution_bounds=(0.0, 1.0),
    ):
        self.problem_size = None
        self.optimal_sol = None
        self.best_sol = None
        self.optimality = None
        self.sol_time_gb = None
        self.sol_time_bfgs = None
        self.num_frac_values = None
        self.q_matrix = None
        self.v_vector = None
        self.solution_vector = None
        self.scaled_by = 1
        self.device = validate_device(device)
        self._custom_name = False
        self.file_delimiter = file_delimiter
        self.file_path = file_path

        instance_values = set(item.value for item in InstanceType)
        if instance_type in instance_values:
            self.instance_type = instance_type
        else:
            raise ValueError("instance_type must be tuning or test")

        if name:
            self.name = name
            self._custom_name = True
        if file_path:
            self.load_instance(
                device=device,
                instance_type=instance_type,
                file_path=file_path,
                file_delimiter=file_delimiter,
            )
        self.problem_category = "boxqp"
        self.solution_bounds = solution_bounds

    @property
    def solution_bounds(self):
        """(min, max) allowed in the solution vector (reference ``:97-114``)."""
        return self._solution_bounds

    @solution_bounds.setter
    def solution_bounds(self, bounds):
        if len(bounds) != 2:
            raise ValueError(
                "solution_bounds must be a tuple of size 2, containing the"
                " minimum and maximum bounds (inclusive)"
            )
        elif bounds[0] >= bounds[1]:
            raise ValueError(
                "Minimum solution bound must be less than maximum solution bound"
            )
        else:
            self._solution_bounds = bounds

    @profiling.annotate("ccvm.load")
    def load_instance(
        self, device="cuda", instance_type="tuning", file_path=None,
        file_delimiter=None,
    ):
        """Loads a box-constrained problem from a file (reference ``:116-224``)."""
        if not file_path and not self.file_path:
            raise Exception("No file path specified, cannot load instance.")
        if file_path:
            self.file_path = file_path
        file_path = self.file_path

        if file_delimiter:
            self.file_delimiter = file_delimiter
        file_delimiter = self.file_delimiter

        q_np, v_np, solution_vector, meta = parse_instance_file(
            file_path, file_delimiter
        )

        self.device = validate_device(device)
        self.instance_type = instance_type
        self._set_problem(q_np, v_np, meta, solution_vector)

        if not self._custom_name:
            # Name the instance after the file (reference :221-224)
            self.name = file_path.split("/")[-1].split(".")[0]

    def _set_problem(self, q64, v64, meta, solution_vector):
        """Install parsed host arrays: float64 host copies for the readout,
        float32 device tensors for the solve."""
        self.problem_size = meta["problem_size"]
        self.optimal_sol = meta["optimal_sol"]
        self.best_sol = meta["best_sol"]
        self.optimality = meta["optimality"]
        self.sol_time_gb = meta["sol_time_gb"]
        self.sol_time_bfgs = meta["sol_time_bfgs"]
        self.num_frac_values = meta["num_frac_values"]
        self._q64 = np.asarray(q64, np.float64)
        self._v64 = np.asarray(v64, np.float64)
        self.q_matrix = put(self._q64.astype(np.float32), self.device)
        self.v_vector = put(self._v64.astype(np.float32), self.device)
        self.solution_vector = solution_vector
        self.scaled_by = 1

    def compute_energy(self, confs):
        """Objective value 0.5 xQx + Vx for a batch of configurations
        (reference ``:226-241``), in float32 on the instance's device."""
        confs = torch.as_tensor(confs, dtype=torch.float32,
                                device=self.q_matrix.device)
        return _energy(confs, self.q_matrix, self.v_vector,
                       float(np.float32(self.scaled_by)))

    def compute_energy_host64(self, confs):
        """Objective value in float64 on the host (readout precision), from
        the ORIGINAL (unscaled) coefficients.  Accepts any leading batch
        dims.  Counts ``rows64``, the rows it evaluates."""
        if isinstance(confs, torch.Tensor):
            profiling.count("host_syncs")
            confs = confs.detach().cpu().numpy()
        x = np.asarray(confs, np.float64)
        profiling.count("rows64", x.size // x.shape[-1])
        q64 = getattr(self, "_q64", None)
        if q64 is not None:
            q, v, scale = q64, self._v64, 1.0
        else:  # programmatically-built instance: fall back to device coefs
            q = self.q_matrix.detach().cpu().numpy().astype(np.float64)
            v = self.v_vector.detach().cpu().numpy().astype(np.float64)
            scale = float(self.scaled_by)
        qx = x @ q
        e = 0.5 * np.sum(x * qx, axis=-1) + x @ v
        return e * scale

    @profiling.annotate("ccvm.readout")
    def compute_energy_readout64(self, confs, gap_margin=None, top_k=64,
                                 change_vars=None):
        """float64-grade readout energies with a device-side f32 first pass.

        Only two things downstream need float64 precision: which side of
        each optimality-gap threshold a row falls on, and the best objective
        value.  So: compute f32 energies on the device, transfer only the
        (2, batch) energies and rounding bounds, and re-evaluate in float64
        only the rows that f32 cannot classify (plus the ``top_k`` best rows
        and rows whose tiny |energy| makes the relative gap ill-conditioned).
        Rows outside the margin keep their f32 value widened to f64 — they
        cannot change any Solution statistic.

        ``gap_margin=None`` (default) uses the rigorous per-row bound from
        the absolute-value energy ``0.5 |x||Q||x| + |V||x|``; a float
        ``gap_margin`` overrides with a fixed margin in gap points.  Falls
        back to :meth:`compute_energy_host64` when no optimum is recorded.

        ``change_vars``: optional ``(mode, lo, hi, S)`` with mode in
        {"boxqp", "langevin"} and scalar ``S``; ``confs`` is then the RAW
        readout variable and the change of variables runs on the device.
        ``confs`` stays on the device; only energies and ambiguous rows
        cross to the host.
        """
        confs = torch.as_tensor(confs, device=self.q_matrix.device)
        opt = self.optimal_sol
        if change_vars is not None:
            mode, lo, hi, S = change_vars
            if np.ndim(S) != 0:
                raise ValueError(
                    "fused change_vars requires a scalar S (per-variable S "
                    "rows cannot be gathered consistently); apply the "
                    "change of variables before calling instead."
                )
            lo, hi, S = (
                torch.full((), float(x), dtype=torch.float32, device=confs.device)
                for x in (lo, hi, S)
            )
            confs = _apply_cv(confs, mode, lo, hi, S)
        if opt is None or confs.ndim != 2:
            return self.compute_energy_host64(confs)

        scaled_by = float(np.float32(self.scaled_by))
        if gap_margin is None:
            raw = _energy_and_bound(confs, self.q_matrix, self.v_vector, scaled_by)
            profiling.count("host_syncs")
            both = raw.cpu().numpy().astype(np.float64)
            e, abs_e = both[0], both[1]
        else:
            raw = _energy(confs, self.q_matrix, self.v_vector, scaled_by)
            profiling.count("host_syncs")
            e = raw.cpu().numpy().astype(np.float64)
            abs_e = None
        near = ambiguous_readout_rows(
            e, opt, confs.shape[-1], abs_e=abs_e, gap_margin=gap_margin,
            top_k=top_k,
        )
        idx = np.flatnonzero(near)
        if idx.size:
            rows = confs[torch.as_tensor(idx, device=confs.device)]
            e[idx] = self.compute_energy_host64(rows)
            # A kept-f32 row can undershoot the true (f64) best energy by up
            # to its rounding bound and steal max(-e); clamp kept rows to
            # the recomputed best.  The shift is below every kept row's gap
            # margin, so no gap statistic can change.
            e = np.maximum(e, e[idx].min())
        return e

    @profiling.annotate("ccvm.scale")
    def scale_coefs(self, scaling_factor):
        """Divide problem coefficients by ``scaling_factor``; consecutive calls
        stack multiplicatively (reference ``:473-479``)."""
        if isinstance(scaling_factor, torch.Tensor):
            sf = scaling_factor.to(torch.float32)
        else:
            sf = float(np.float32(scaling_factor))
        self.q_matrix = self.q_matrix / sf
        self.v_vector = self.v_vector / sf
        if isinstance(sf, torch.Tensor):
            profiling.count("host_syncs")
        self.scaled_by = self.scaled_by * float(sf)
