"""Lis-compatible run-time option registry.

The reference drives every knob through ``-name value`` string pairs parsed
by lis_solver_set_option (src/solver/lis_solver.c:1122, names at :175-197)
into int/float slots on the solver object; the eigensolver has the same
scheme (src/esolver/lis_esolver.c:697+).  We reproduce the full option-name
surface onto typed dataclasses, so option strings written for Lis
(e.g. ``"-i bicgstab -p ilu -ilu_fill 1 -tol 1e-10"``) work unchanged.

Defaults mirror lis_solver_init (src/solver/lis_solver.c:219-291) and
lis_esolver_init (src/esolver/lis_esolver.c:143-183).
"""

from __future__ import annotations

import dataclasses
import shlex
from dataclasses import dataclass, field

from lis_tpu import config as C

# name → id tables (src/solver/lis_solver.c lis_solver_atoi / lis_precon_atoi)
SOLVER_NAMES = [
    "cg", "bicg", "cgs", "bicgstab", "bicgstabl", "gpbicg", "tfqmr",
    "orthomin", "gmres", "jacobi", "gs", "sor", "bicgsafe", "cr", "bicr",
    "crs", "bicrstab", "gpbicr", "bicrsafe", "fgmres", "idrs", "idr1",
    "minres", "cocg", "cocr",
]
SOLVER_IDS = {name: i + 1 for i, name in enumerate(SOLVER_NAMES)}

PRECON_NAMES = [
    "none", "jacobi", "ilu", "ssor", "hybrid", "is", "sainv", "saamg",
    "iluc", "ilut", "bjacobi",
]
PRECON_IDS = {name: i for i, name in enumerate(PRECON_NAMES)}

# eigensolver names (src/esolver/lis_esolver.c:118-124)
ESOLVER_NAMES = [
    "pi", "ii", "rqi", "cg", "cr", "si", "li", "ai",
    "gpi", "gii", "grqi", "gcg", "gcr", "gsi", "gli", "gai",
]
ESOLVER_IDS = {name: i + 1 for i, name in enumerate(ESOLVER_NAMES)}

STORAGE_NAMES = {name: i + 1 for i, name in enumerate(
    ["csr", "csc", "msr", "dia", "ell", "jad", "bsr", "bsc", "vbr", "coo",
     "dns",
     # extensions beyond the reference's 11 formats
     "hdi", "bes", "css", "cst"])}

PRINT_NAMES = {"none": 0, "mem": 1, "out": 2, "all": 3}
SCALE_NAMES = {"none": 0, "jacobi": 1, "symm_diag": 2}
CONV_COND_NAMES = {"nrm2_r": 0, "nrm2_b": 1, "nrm1_b": 2}
PRECISION_NAMES = {"double": 0, "quad": 1, "switch": 2,
                   # extensions: f32 and f32-pair double-float
                   "single": 3, "df": 4, "switch_df": 5}
TRUEFALSE = {"false": 0, "true": 1, "0": 0, "1": 1}


@dataclass
class SolverOptions:
    """All linear-solver options, names 1:1 with the reference's flags."""
    solver: str = "bicg"            # -i
    precon: str = "none"            # -p
    maxiter: int = 1000             # -maxiter
    tol: float = 1.0e-12            # -tol
    tol_w: float = 1.0              # -tol_w (weight for nrm1_b criterion)
    print_: int = 0                 # -print {none|mem|out|all}
    scale: int = 0                  # -scale {none|jacobi|symm_diag}
    conv_cond: int = 0              # -conv_cond {nrm2_r|nrm2_b|nrm1_b}
    restart: int = 40               # -restart (GMRES/FGMRES/Orthomin)
    ell: int = 2                    # -ell (BiCGSTAB(l))
    m: int = 3                      # -m / -is_m
    omega: float = 1.9              # -omega (SOR)
    ssor_omega: float = 1.0         # -ssor_omega
    ssor_sweeps: int = 2            # -ssor_sweeps (relaxed-sweep count on
                                    #  the DIA path; extension)
    ilu_fill: int = 0               # -ilu_fill
    ilu_relax: float = 1.0          # -ilu_relax
    is_alpha: float = 1.0           # -is_alpha
    is_level: int = 1               # -is_level
    hybrid_i: str = "sor"           # -hybrid_i
    hybrid_maxiter: int = 25        # -hybrid_maxiter
    hybrid_ell: int = 2             # -hybrid_ell
    hybrid_restart: int = 40        # -hybrid_restart
    hybrid_tol: float = 1.0e-3      # -hybrid_tol
    hybrid_omega: float = 1.5       # -hybrid_omega
    hybrid_p: str = "none"          # -hybrid_p
    sainv_drop: float = 0.05        # -sainv_drop
    iluc_drop: float = 0.05         # -iluc_drop
    iluc_gamma: float = 1.0         # -iluc_gamma
    iluc_rate: float = 5.0          # -iluc_rate
    saamg_unsym: bool = False       # -saamg_unsym
    saamg_theta: float = 0.05       # -saamg_theta
    saamg_smoother: str = "sgs"     # -saamg_smoother {sgs|jacobi}
    saamg_lattice: bool = True      # -saamg_lattice (streamed box path)
    saamg_shard_rows: int = 256     # -saamg_shard_rows (dist: shard coarse
                                    #  levels while rows > this × ndev)
    adds: bool = False              # -adds (additive Schwarz wrapper)
    adds_iter: int = 1              # -adds_iter
    initx_zeros: bool = True        # -initx_zeros
    precision: str = "double"       # -f {double|quad|switch}
    switch_tol: float = 1.0e-12     # -switch_tol
    switch_maxiter: int = -1        # -switch_maxiter
    use_at: bool = False            # -use_at (explicit Aᵀ for BiCG family)
    storage: int = 0                # -storage (0 = auto: DIA for banded)
    auto_storage: bool = True       # -auto_storage (measured-rate routing)
    reorder: str = "none"           # -reorder {none|rcm}: solve P A Pt
    storage_block: int = 2          # -storage_block
    irestart: int = 2               # -irestart (IDR(s) shadow dim)
    ric2s_tau: float = 0.05         # -ric2s_tau
    ric2s_sigma: float = 2.0        # -ric2s_sigma
    ric2s_gamma: float = 1.0        # -ric2s_gamma

    @property
    def solver_id(self) -> int:
        return SOLVER_IDS[self.solver]

    @property
    def precon_id(self) -> int:
        # user-registered preconditioners number from the end of the
        # built-in table (LIS_PRECON_TYPE_USERDEF = LIS_PRECON_TYPE_LEN,
        # include/lis.h:250)
        if self.precon not in PRECON_IDS:
            from lis_tpu.precon.base import user_precon_id
            return user_precon_id(self.precon, len(PRECON_NAMES))
        return PRECON_IDS[self.precon]

    @classmethod
    def from_string(cls, opts: str | None = None, include_cmdline: bool = False,
                    **overrides) -> "SolverOptions":
        self = cls()
        if include_cmdline:
            _apply_tokens(self, C.get_cmd_args(), _SOLVER_ACTIONS)
        if opts:
            _apply_tokens(self, shlex.split(opts), _SOLVER_ACTIONS)
        for k, v in overrides.items():
            setattr(self, k, v)
        return self


@dataclass
class EsolverOptions:
    """Eigensolver options (reference: -e, -ss, -ie, ... lis_esolver.c)."""
    esolver: str = "cr"             # -e  (reference default is CR)
    maxiter: int = 1000             # -emaxiter
    tol: float = 1.0e-12            # -etol
    print_: int = 0                 # -eprint
    ss: int = 1                     # -ss (subspace size)
    inner_esolver: str = "ii"       # -ie (inner esolver for SI/LI/AI)
    rval: float = 0.0               # -shift (sigma)
    shift_im: float = 0.0           # -shift_im
    ritz_only: bool = False         # -rval {true|false}: LI/AI return the
                                    # raw Ritz values, skipping the
                                    # per-pair inner refinement
                                    # (LIS_EOPTIONS_RVAL, truefalse)
    initx_ones: bool = True         # -initx_ones (alias -einitx_ones)
    mode: int = 0                   # -m (eigenvalue mode index)
    inner_gesolver: str = "ii"      # -ige (inner esolver, generalized)
    estorage: int = 0               # -estorage (0 = keep input format)
    estorage_block: int = 2         # -estorage_block
    precision: str = "double"       # -ef {double|quad}
    # inner linear-solver options (II/RQI run a Krylov solve per iteration)
    inner: SolverOptions = field(default_factory=lambda: SolverOptions(
        solver="bicg", precon="none", maxiter=1000, tol=1e-12))

    @property
    def esolver_id(self) -> int:
        return ESOLVER_IDS[self.esolver]

    @classmethod
    def from_string(cls, opts: str | None = None, **overrides) -> "EsolverOptions":
        self = cls()
        if opts:
            toks = shlex.split(opts)
            rest = _apply_tokens(self, toks, _ESOLVER_ACTIONS, collect_rest=True)
            # leftover tokens configure the inner linear solver (-i/-p/...)
            if rest:
                self.inner = SolverOptions.from_string(" ".join(rest))
        for k, v in overrides.items():
            setattr(self, k, v)
        return self


def _set_enum(attr, table):
    def act(o, v):
        v = v.lower()
        if v not in table and attr in ("print_", "scale", "conv_cond"):
            # numeric forms also accepted, like the reference
            setattr(o, attr, int(v))
            return
        setattr(o, attr, table[v] if v in table else v)
    return act


def _set_name(attr, table):
    def act(o, v):
        v = v.lower()
        if v.isdigit():
            names = {i: n for n, i in table.items()}
            setattr(o, attr, names[int(v)])
        else:
            if v not in table:
                if attr == "precon":
                    # user preconditioners registered at runtime
                    # (lis_precon_register, reference lis_precon.c:411)
                    # are addressable by -p <name> like built-ins
                    from lis_tpu.precon.base import PRECON_REGISTRY
                    if v in PRECON_REGISTRY:
                        setattr(o, attr, v)
                        return
                raise ValueError(f"unknown value {v!r} for -{attr}")
            setattr(o, attr, v)
    return act


def _set_int(attr):
    return lambda o, v: setattr(o, attr, int(v))


def _set_float(attr):
    return lambda o, v: setattr(o, attr, float(v))


def _set_bool(attr, flag=None):
    name = flag or attr                 # error messages show the CLI flag
    def act(o, v):
        try:
            setattr(o, attr, bool(TRUEFALSE[v.lower()]))
        except KeyError:
            raise ValueError(
                f"unknown value {v!r} for -{name} "
                f"(expected one of {sorted(TRUEFALSE)})") from None
    return act


def _set_storage(o, v):
    v = v.lower()
    o.storage = int(v) if v.isdigit() else STORAGE_NAMES[v]


# option name → action (mirrors LIS_SOLVER_OPTNAME/OPTACT,
# src/solver/lis_solver.c:175-197)
_SOLVER_ACTIONS = {
    "-maxiter": _set_int("maxiter"),
    "-tol": _set_float("tol"),
    "-tol_w": _set_float("tol_w"),
    "-print": _set_enum("print_", PRINT_NAMES),
    "-scale": _set_enum("scale", SCALE_NAMES),
    "-conv_cond": _set_enum("conv_cond", CONV_COND_NAMES),
    "-ssor_omega": _set_float("ssor_omega"),
    "-ssor_sweeps": _set_int("ssor_sweeps"),
    "-ilu_fill": _set_int("ilu_fill"),
    "-ilu_relax": _set_float("ilu_relax"),
    "-is_alpha": _set_float("is_alpha"),
    "-is_level": _set_int("is_level"),
    "-is_m": _set_int("m"),
    "-m": _set_int("m"),
    "-hybrid_maxiter": _set_int("hybrid_maxiter"),
    "-hybrid_ell": _set_int("hybrid_ell"),
    "-hybrid_restart": _set_int("hybrid_restart"),
    "-hybrid_tol": _set_float("hybrid_tol"),
    "-hybrid_omega": _set_float("hybrid_omega"),
    "-hybrid_i": _set_name("hybrid_i", SOLVER_IDS),
    "-hybrid_p": _set_name("hybrid_p", PRECON_IDS),
    "-sainv_drop": _set_float("sainv_drop"),
    "-ric2s_tau": _set_float("ric2s_tau"),
    "-ric2s_sigma": _set_float("ric2s_sigma"),
    "-ric2s_gamma": _set_float("ric2s_gamma"),
    "-restart": _set_int("restart"),
    "-ell": _set_int("ell"),
    "-omega": _set_float("omega"),
    "-i": _set_name("solver", SOLVER_IDS),
    "-p": _set_name("precon", PRECON_IDS),
    "-f": _set_name("precision", PRECISION_NAMES),
    "-initx_zeros": _set_bool("initx_zeros"),
    "-adds": _set_bool("adds"),
    "-adds_iter": _set_int("adds_iter"),
    "-use_at": _set_bool("use_at"),
    "-switch_tol": _set_float("switch_tol"),
    "-switch_maxiter": _set_int("switch_maxiter"),
    "-saamg_unsym": _set_bool("saamg_unsym"),
    "-saamg_theta": _set_float("saamg_theta"),
    "-saamg_smoother": lambda o, v: setattr(o, "saamg_smoother", v.lower()),
    "-saamg_lattice": _set_bool("saamg_lattice"),
    "-saamg_shard_rows": _set_int("saamg_shard_rows"),
    "-iluc_drop": _set_float("iluc_drop"),
    "-iluc_gamma": _set_float("iluc_gamma"),
    "-iluc_rate": _set_float("iluc_rate"),
    "-storage": _set_storage,
    "-reorder": lambda o, v: setattr(o, "reorder", v.lower()),
    "-auto_storage": lambda o, v: setattr(o, "auto_storage",
                                          bool(TRUEFALSE[v.lower()])),
    "-storage_block": _set_int("storage_block"),
    "-irestart": _set_int("irestart"),
}

_ESOLVER_ACTIONS = {
    "-e": _set_name("esolver", ESOLVER_IDS),
    "-emaxiter": _set_int("maxiter"),
    "-etol": _set_float("tol"),
    "-eprint": _set_enum("print_", PRINT_NAMES),
    "-ss": _set_int("ss"),
    "-ie": _set_name("inner_esolver", ESOLVER_IDS),
    "-shift": _set_float("rval"),
    "-shift_im": _set_float("shift_im"),
    "-einitx_ones": lambda o, v: setattr(o, "initx_ones",
                                         bool(TRUEFALSE[v.lower()])),
    "-initx_ones": lambda o, v: setattr(o, "initx_ones",
                                        bool(TRUEFALSE[v.lower()])),
    "-m": _set_int("mode"),
    "-rval": _set_bool("ritz_only", flag="rval"),
    "-ige": _set_name("inner_gesolver", ESOLVER_IDS),
    "-estorage": _set_int("estorage"),
    "-estorage_block": _set_int("estorage_block"),
    "-ef": _set_name("precision", PRECISION_NAMES),
}


def _show_help(obj):
    """-h (reference: lis_solve usage banner, lis_solver.c SHOWHELP)."""
    names = sorted(_SOLVER_ACTIONS) + ["-h", "-ver"]
    print("lis_tpu solver options:")
    for n in names:
        print(f"  {n} <value>" if n not in ("-h", "-ver") else f"  {n}")


def _show_version(obj):
    import lis_tpu
    print(f"lis_tpu {lis_tpu.__version__} (Lis-compatible JAX framework)")


_FLAG_ACTIONS = {"-h": _show_help, "-ver": _show_version}


def _apply_tokens(obj, tokens, actions, collect_rest: bool = False):
    rest = []
    i = 0
    while i < len(tokens):
        tok = tokens[i]
        flag = _FLAG_ACTIONS.get(tok)
        if flag is not None:
            flag(obj)
            i += 1
            continue
        act = actions.get(tok)
        if act is not None and i + 1 < len(tokens):
            act(obj, tokens[i + 1])
            i += 2
        elif act is not None:
            raise ValueError(f"option {tok} is missing its value")
        else:
            if collect_rest:
                rest.append(tok)
                if (tok.startswith("-") and i + 1 < len(tokens)
                        and not tokens[i + 1].startswith("-")):
                    rest.append(tokens[i + 1])
                    i += 1
            i += 1
    return rest if collect_rest else None
