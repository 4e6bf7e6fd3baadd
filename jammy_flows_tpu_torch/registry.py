"""Flow registry: DSL symbol -> layer class, manifold type, validated options.

PyTorch counterpart of ``jammy_flows_tpu/registry.py``: the same option
tables, defaults and validators (tests/test_torch_registry.py holds the two
equal).  Layer classes are imported lazily.  Every symbol is ported: the
Euclidean ones (`g`, `h`, `t`, `x`), the circle ones (`m`, `o`, `y`), the
interval ones (`r`, `z`), the simplex ones (`u`, `w`) and the s2 ones (`f`,
`v`, `c`); ``get_layer_class`` raises ``NotImplementedError`` for a class
missing from ``_PORTED``.
"""
from __future__ import annotations


def _positive(x):
    return x > 0


def _pos_or_minus_one(x):
    return (x == -1) or (x > 0)


def _posf_or_minus_one(x):
    return (x == -1.0) or (x > 0.0)


_BOOL = [0, 1]
_PKG = "jammy_flows_tpu_torch.layers"

# symbol -> (manifold_type, module_path, class_name, {opt: (default, validator)})
OPTS = {
    # ----- Euclidean -----
    "g": ("e", _PKG + ".euclidean", "GaussianizationFlow", {
        "fit_normalization": (1, _BOOL),
        "num_householder_iter": (-1, _pos_or_minus_one),
        "num_kde": (10, _positive),
        "inverse_function_type": ("isigmoid", ["isigmoid", "inormal_partly_precise",
                                               "inormal_full_pade", "inormal_partly_crude"]),
        "replace_first_sigmoid_with_icdf": (1, _BOOL),
        "skip_model_offset": (0, _BOOL),
        "softplus_for_width": (0, _BOOL),
        "upper_bound_for_widths": (100, _pos_or_minus_one),
        "lower_bound_for_widths": (0.01, _positive),
        "upper_bound_for_norms": (10, _pos_or_minus_one),
        "lower_bound_for_norms": (1, _positive),
        "center_mean": (0, _BOOL),
        "clamp_widths": (0, _BOOL),
        "width_smooth_saturation": (1, _BOOL),
        "regulate_normalization": (1, _BOOL),
        "add_skewness": (0, _BOOL),
        "rotation_mode": ("householder", ["householder", "triangular_combination",
                                          "angles", "cayley", "none"]),
        "nonlinear_stretch_type": ("classic", ["classic", "rq_splines"]),
        "high_precision_tail_newton": (0, lambda x: isinstance(x, int)
                                       and x >= 0),
    }),
    "h": ("e", _PKG + ".euclidean", "GaussianizationFlow", {
        "fit_normalization": (1, _BOOL),
        "num_householder_iter": (-1, _pos_or_minus_one),
        "num_kde": (10, _positive),
        "inverse_function_type": ("isigmoid", ["isigmoid", "inormal_partly_precise",
                                               "inormal_full_pade", "inormal_partly_crude"]),
        "replace_first_sigmoid_with_icdf": (1, _BOOL),
        "skip_model_offset": (0, _BOOL),
        "softplus_for_width": (0, _BOOL),
        "upper_bound_for_widths": (100, _pos_or_minus_one),
        "lower_bound_for_widths": (0.01, _positive),
        "clamp_widths": (0, _BOOL),
        "width_smooth_saturation": (1, _BOOL),
        "regulate_normalization": (1, _BOOL),
        "add_skewness": (0, _BOOL),
    }),
    "t": ("e", _PKG + ".euclidean", "MultivariateNormal", {
        "skip_model_offset": (0, _BOOL),
        "softplus_for_width": (0, _BOOL),
        "upper_bound_for_widths": (100, _pos_or_minus_one),
        "lower_bound_for_widths": (0.01, _positive),
        "clamp_widths": (0, _BOOL),
        "width_smooth_saturation": (1, _BOOL),
        "cov_type": ("diagonal", ["identity", "diagonal_symmetric", "diagonal", "full"]),
    }),
    "x": ("e", _PKG + ".euclidean", "EuclideanIdentity", {
        "add_offset": (0, _BOOL),
    }),
    # ----- S1 -----
    "m": ("s", _PKG + ".sphere", "Moebius", {
        "add_rotation": (0, _BOOL),
        "num_basis_functions": (5, _positive),
        "natural_direction": (0, _BOOL),
    }),
    "o": ("s", _PKG + ".sphere", "CircularRQSpline", {
        "add_rotation": (1, _BOOL),
        "num_basis_functions": (2, _positive),
        "natural_direction": (1, _BOOL),
        "fix_boundary_derivatives": (-1.0, _posf_or_minus_one),
        "smooth_second_derivative": (1, _BOOL),
        "fix_first_width_n_height_to_zero": (0, _BOOL),
        "also_fix_second_width_to_zero": (0, _BOOL),
        "independent_width_height_parametrization": (0, _BOOL),
        "min_width": (1e-4, _positive),
        "min_height": (1e-4, _positive),
        "min_derivative": (1e-4, _positive),
    }),
    # ----- S2 -----
    "v": ("s", _PKG + ".sphere_s2", "ExponentialMapS2", {
        "exp_map_type": ("exponential", ["linear", "quadratic", "splines", "exponential"]),
        "num_components": (10, _positive),
        "natural_direction": (0, _BOOL),
        "add_rotation": (0, _BOOL),
        "max_num_newton_iter": (1000, _positive),
        "mean_parametrization": ("old", ["old", "householder"]),
    }),
    "c": ("s", _PKG + ".sphere_cnf", "CNFSphereCharts", {
        "num_charts": (4, _positive),
        "cnf_network_hidden_dims": ("32", lambda x: isinstance(x, str)),
        "cnf_network_highway_mode": (0, [0, 1, 2, 3, 4]),
        "cnf_network_rank": (-1, _pos_or_minus_one),
        "solver": ("dopri5", ["rk4", "dopri5", "dopri8", "bosh3", "fehlberg2",
                              "adaptive_heun", "euler", "midpoint"]),
        "rtol": (1e-7, lambda x: (x > 0) & (x < 1)),
        "atol": (1e-7, lambda x: (x > 0) & (x < 1)),
        "step_size": (1.0 / 32.0, _positive),
    }),
    "f": ("s", _PKG + ".sphere_s2", "FisherVonMises2D", {
        "add_vertical_rq_spline_flow": (0, _BOOL),
        "add_circular_rq_spline_flow": (0, _BOOL),
        "add_correlated_rq_spline_flow": (0, _BOOL),
        "circular_flow_defs": ("oo", lambda x: isinstance(x, str)),
        "vertical_flow_defs": ("rr", lambda x: isinstance(x, str)),
        "correlated_max_rank": (3, lambda x: x >= 0),
        "inverse_z_scaling": (1, _BOOL),
        "boundary_cos_theta_identity_region": (0.0, lambda x: (x >= 0) & (x < 1)),
        "spline_num_basis_functions": (5, lambda x: (x > 0) | (x == -1)),
        "vertical_smooth": (0, _BOOL),
        "vertical_restrict_max_min_width_height_ratio": (-1.0, _posf_or_minus_one),
        "vertical_fix_boundary_derivative": (1, _BOOL),
        "vertical_fix_first_width_n_height_to_zero": (0, _BOOL),
        "vertical_also_fix_second_width_to_zero": (0, _BOOL),
        "vertical_independent_width_height_parametrization": (0, _BOOL),
        "circular_add_rotation": (0, _BOOL),
        "min_kappa": (1e-10, _positive),
        "kappa_prediction": ("direct_log_real_bounded",
                             ["direct_log_real_bounded", "softplus_real_bounded",
                              "log_bounded", "mu", "mu_squared", "quatvec",
                              "quatvec_squared"]),
        "add_extra_rotation_inbetween": (0, _BOOL),
        "add_rotation": (1, _BOOL),
        "rotation_mode": ("householder", ["householder", "angles", "xyz", "quaternion"]),
        "kappa_clamping": (0, _BOOL),
        "num_householder_iter": (-1, _pos_or_minus_one),
    }),
    "y": ("s", _PKG + ".sphere", "SphericalIdentity", {
        "add_rotation": (0, _BOOL),
    }),
    # ----- Interval -----
    "r": ("i", _PKG + ".interval", "RQSplineInterval", {
        "num_basis_functions": (5, _positive),
        "fix_boundary_derivatives": (-1.0, _posf_or_minus_one),
        "smooth_second_derivative": (0, lambda x: isinstance(x, int) and x >= 0),
        "restrict_max_min_width_height_ratio": (-1.0, _posf_or_minus_one),
        "fix_first_width_n_height_to_zero": (0, _BOOL),
        "also_fix_second_width_to_zero": (0, _BOOL),
        "independent_width_height_parametrization": (0, _BOOL),
        "min_width": (1e-4, _positive),
        "min_height": (1e-4, _positive),
        "min_derivative": (1e-4, _positive),
    }),
    "z": ("i", _PKG + ".interval", "IntervalIdentity", {}),
    # ----- Simplex -----
    "u": ("a", _PKG + ".simplex", "GumbelSoftmax", {}),
    "w": ("a", _PKG + ".simplex", "InnerLoopSimplex", {}),
}

# the layer classes the port has
_PORTED = {"GaussianizationFlow", "MultivariateNormal", "EuclideanIdentity",
            "FisherVonMises2D", "ExponentialMapS2", "CNFSphereCharts",
            "Moebius", "CircularRQSpline", "SphericalIdentity",
            "RQSplineInterval", "IntervalIdentity", "GumbelSoftmax",
            "InnerLoopSimplex"}


def obtain_default_options(flow_abbreviation):
    """Default option dict for a flow symbol."""
    if flow_abbreviation not in OPTS:
        raise ValueError(
            f"Unknown flow abbreviation for default options: {flow_abbreviation}")
    return {k: v[0] for k, v in OPTS[flow_abbreviation][3].items()}


def check_flow_option(flow_abbreviation, opt_name, opt_val):
    """Validate a configured option; raises ValueError when invalid."""
    if flow_abbreviation not in OPTS:
        raise ValueError(
            f"flow abbreviation {flow_abbreviation} not found in options dict")
    opts = OPTS[flow_abbreviation][3]
    if opt_name not in opts:
        raise ValueError(f"option name {opt_name} not found in defined options "
                         f"for flow {flow_abbreviation}")
    validator = opts[opt_name][1]
    if callable(validator):
        ok = validator(opt_val)
    else:
        ok = opt_val in validator
    if not ok:
        raise ValueError(f"Option {opt_name}={opt_val!r} rejected for flow "
                         f"{flow_abbreviation}")


def manifold_type(flow_abbreviation):
    return OPTS[flow_abbreviation][0]


def get_layer_class(flow_abbreviation):
    import importlib
    _, module_path, class_name, _ = OPTS[flow_abbreviation]
    if class_name not in _PORTED:
        raise NotImplementedError(
            f"flow symbol {flow_abbreviation!r} ({class_name}) is not ported "
            "yet (ROADMAP.md, Queue 1)")
    mod = importlib.import_module(module_path)
    return getattr(mod, class_name)
