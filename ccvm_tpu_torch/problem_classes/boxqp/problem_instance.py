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
requested device in float32, and float32 products run with TF32 off.  The
readout (``compute_energy_readout64``, ``stacked_readout64``) evaluates every
row in IEEE float64 on the device, from a float64 copy of the parsed
coefficients, and copies the energies to the host once.
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
    """Batched BoxQP objective 0.5 xQx + Vx, scaled, in IEEE float32."""
    with fp32_matmul():
        qx = torch.matmul(confs, q_matrix)
        energy1 = torch.sum(confs * qx, dim=-1) * scaled_by
        energy2 = torch.matmul(confs, v_vector) * scaled_by
    return 0.5 * energy1 + energy2


def _readout64(confs, coefs, scale):
    """0.5 xQx + Vx of every row in IEEE float64 on the confs' device,
    copied to the host once and times ``scale`` there (a float, or an
    (I, 1) array over an instance axis): a NumPy float64 array.  ``coefs``
    holds Q's rows and then V: (n + 1, n) for confs of any leading dims, or
    (I, n + 1, n) for (I, B, n) confs over an instance axis."""
    x = confs.to(torch.float64)
    terms = torch.matmul(x, coefs[..., :-1, :]).mul_(0.5).add_(coefs[..., -1:, :]).mul_(x)
    e = torch.sum(terms, dim=-1)
    profiling.count("rows64_card", e.numel())
    profiling.count("host_syncs")
    return e.cpu().numpy() * scale


@profiling.annotate("ccvm.readout")
def stacked_readout64(instances, confs):
    """The float64 readout of a stacked sweep
    (``ccvm_tpu/parallel/sweep.py:84-151``): (I, batch) energies, each row
    as :meth:`ProblemInstance.compute_energy_readout64` gives it for one
    instance.  The instances' float64 coefficients stack on the device of
    the (I, batch, n) ``confs``, one batched float64 product gives every
    energy, and they cross to the host in one (I, batch) copy."""
    _keep64(instances, confs.device)
    coefs, scales = zip(*(inst._coefs64(confs.device) for inst in instances))
    return _readout64(confs, torch.stack(coefs), np.array(scales, np.float64)[:, None])


def _keep64(instances, device):
    """Give each instance parsed from float64 coefficients a copy of them on
    ``device``, Q's rows and V's as one (n + 1, n) tensor, kept on the
    instance; the copies missing are made together, in one copy."""
    missing = [inst for inst in instances if getattr(inst, "_q64", None) is not None
               and (inst._card64 is None or inst._card64.device != device)]
    if missing:
        block = torch.as_tensor(
            np.stack([np.vstack([inst._q64, inst._v64]) for inst in missing]), device=device)
        for inst, coefs in zip(missing, block.unbind(0)):
            inst._card64 = coefs


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
        """Install parsed host arrays: float64 host copies for the readout
        (copied to the device at its first use), float32 device tensors for
        the solve."""
        self.problem_size = meta["problem_size"]
        self.optimal_sol = meta["optimal_sol"]
        self.best_sol = meta["best_sol"]
        self.optimality = meta["optimality"]
        self.sol_time_gb = meta["sol_time_gb"]
        self.sol_time_bfgs = meta["sol_time_bfgs"]
        self.num_frac_values = meta["num_frac_values"]
        self._q64 = np.asarray(q64, np.float64)
        self._v64 = np.asarray(v64, np.float64)
        self._card64 = None
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

    def _coefs64(self, device):
        """The readout's float64 coefficients on ``device`` (Q's rows and
        then V, (n + 1, n)) and their scale: a copy of the original
        (unscaled) coefficients with scale 1.0, made at first use and kept;
        an instance built without them takes its float32 coefficients
        widened and ``scaled_by``, as :meth:`compute_energy_host64` does."""
        if getattr(self, "_q64", None) is None:
            coefs = torch.cat([self.q_matrix, self.v_vector[None]])
            return coefs.to(device, torch.float64), float(self.scaled_by)
        _keep64([self], device)
        return self._card64, 1.0

    @profiling.annotate("ccvm.readout")
    def compute_energy_readout64(self, confs, change_vars=None):
        """Readout energies: every row's 0.5 xQx + Vx of the original
        (unscaled) coefficients in IEEE float64, computed on the device
        that holds ``confs`` and copied to the host once, as a NumPy
        float64 array over ``confs``' leading dims.

        ``change_vars``: optional ``(mode, lo, hi, S)`` with mode in
        {"boxqp", "langevin"} and scalar ``S``; ``confs`` is then the RAW
        readout variable and the change of variables runs on the device in
        float32, as the solvers' own does.
        """
        confs = torch.as_tensor(confs, device=self.q_matrix.device)
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
        return _readout64(confs, *self._coefs64(confs.device))

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
