"""Validation + plotting: the reference postprocess stage, matplotlib twin.

Maps SPH_Poiseuille_postprocess.m:

* L2 relative error vs the analytic profile over non-empty bins, pass/fail
  at 5% (m:37-48).
* Figure 1: normalized velocity profile vs analytic (left) + interpolated
  velocity-field heatmap with gray wall bands (right) (m:54-83, 184-243).
* Figure 2: mid-channel profile evolution curves colored by time with the
  dashed analytic target (m:85-126).

Decoupled from the solver via an ``.npz`` handoff (the reference's -v7.3
.mat, SPH_Poiseuille.m:304-310) so it can also run standalone.

Port note: numpy only, like its JAX twin. Where matplotlib (or scipy, for
the heatmap) is not installed, ``run_postprocess`` still prints the L2
verdict and returns it, and logs one line saying the figures were skipped.
"""

from __future__ import annotations

import json
import os
import warnings
from typing import Optional

import numpy as np

L2_PASS_THRESHOLD = 0.05

# MATLAB's parula colormap (the reference's line colormap for the
# profile-evolution figure, SPH_Poiseuille_postprocess.m:89) — matplotlib
# ships no parula, so the standard public 64-anchor RGB table is embedded
# and resampled per figure.
_PARULA_DATA = [
    [0.2081, 0.1663, 0.5292], [0.2116, 0.1898, 0.5777],
    [0.2123, 0.2138, 0.6270], [0.2081, 0.2386, 0.6771],
    [0.1959, 0.2645, 0.7279], [0.1707, 0.2919, 0.7790],
    [0.1253, 0.3242, 0.8303], [0.0591, 0.3598, 0.8683],
    [0.0117, 0.3875, 0.8820], [0.0060, 0.4086, 0.8828],
    [0.0165, 0.4266, 0.8786], [0.0329, 0.4430, 0.8720],
    [0.0498, 0.4586, 0.8641], [0.0629, 0.4737, 0.8554],
    [0.0723, 0.4887, 0.8467], [0.0779, 0.5040, 0.8384],
    [0.0793, 0.5200, 0.8312], [0.0749, 0.5375, 0.8263],
    [0.0641, 0.5570, 0.8240], [0.0488, 0.5772, 0.8228],
    [0.0343, 0.5966, 0.8199], [0.0265, 0.6137, 0.8135],
    [0.0239, 0.6287, 0.8038], [0.0231, 0.6418, 0.7913],
    [0.0228, 0.6535, 0.7768], [0.0267, 0.6642, 0.7607],
    [0.0384, 0.6743, 0.7436], [0.0590, 0.6838, 0.7254],
    [0.0843, 0.6928, 0.7062], [0.1133, 0.7015, 0.6859],
    [0.1453, 0.7098, 0.6646], [0.1801, 0.7177, 0.6424],
    [0.2178, 0.7250, 0.6193], [0.2586, 0.7317, 0.5954],
    [0.3022, 0.7376, 0.5712], [0.3482, 0.7424, 0.5473],
    [0.3953, 0.7459, 0.5244], [0.4420, 0.7481, 0.5033],
    [0.4871, 0.7491, 0.4840], [0.5300, 0.7491, 0.4661],
    [0.5709, 0.7485, 0.4494], [0.6099, 0.7473, 0.4337],
    [0.6473, 0.7456, 0.4188], [0.6834, 0.7435, 0.4044],
    [0.7184, 0.7411, 0.3905], [0.7525, 0.7384, 0.3768],
    [0.7858, 0.7356, 0.3633], [0.8185, 0.7327, 0.3498],
    [0.8507, 0.7299, 0.3360], [0.8824, 0.7274, 0.3217],
    [0.9139, 0.7258, 0.3063], [0.9450, 0.7261, 0.2886],
    [0.9739, 0.7314, 0.2666], [0.9938, 0.7455, 0.2403],
    [0.9990, 0.7653, 0.2164], [0.9955, 0.7861, 0.1967],
    [0.9880, 0.8066, 0.1794], [0.9789, 0.8271, 0.1633],
    [0.9697, 0.8481, 0.1475], [0.9626, 0.8705, 0.1309],
    [0.9589, 0.8949, 0.1132], [0.9598, 0.9218, 0.0948],
    [0.9661, 0.9514, 0.0755], [0.9763, 0.9831, 0.0538],
]


def parula_cmap(n: int):
    """Parula resampled to ``n`` discrete colors (MATLAB ``parula(n)``)."""
    from matplotlib.colors import LinearSegmentedColormap
    return LinearSegmentedColormap.from_list("parula", _PARULA_DATA, N=n)


def binned_profile_mean(y_values, u_values, y_min: float, y_max: float,
                        n_bins: int):
    """Mean u per y-bin with MATLAB ``discretize`` semantics: bins
    [e_k, e_{k+1}) except the last which includes its right edge; samples
    outside [y_min, y_max] are dropped; empty bins are NaN
    (reference: SPH_Poiseuille.m:579-590)."""
    edges = np.linspace(y_min, y_max, n_bins + 1)
    y_mid = 0.5 * (edges[:-1] + edges[1:])
    ids = np.digitize(y_values, edges) - 1
    ids = np.where(y_values == edges[-1], n_bins - 1, ids)
    valid = (ids >= 0) & (ids < n_bins)
    sum_u = np.bincount(ids[valid], weights=u_values[valid],
                        minlength=n_bins)
    cnt = np.bincount(ids[valid], minlength=n_bins).astype(float)
    u_mean = sum_u / np.maximum(cnt, 1.0)
    u_mean[cnt == 0] = np.nan
    return y_mid, u_mean


def mid_channel_profile(x, y, u_x, DL: float, DH: float, mid_x: float,
                        half_width: float, n_bins: int):
    """u(y) over the periodic mid-channel slice
    (reference: SPH_Poiseuille.m:592-605)."""
    x_wrap = np.mod(x, DL)
    dx_mid = np.abs(x_wrap - mid_x)
    dx_mid = np.minimum(dx_mid, DL - dx_mid)
    is_mid = dx_mid <= half_width
    if not np.any(is_mid):
        return binned_profile_mean(np.array([]), np.array([]), 0.0, DH,
                                   n_bins)
    return binned_profile_mean(y[is_mid], u_x[is_mid], 0.0, DH, n_bins)


def compute_l2_error(u_mean, u_exact) -> float:
    """L2 relative error over non-empty bins
    (reference: SPH_Poiseuille_postprocess.m:37-43)."""
    valid = ~np.isnan(u_mean)
    if not np.any(valid):
        raise ValueError("velocity-profile binning is empty")
    num = np.sum((u_mean[valid] - u_exact[valid]) ** 2)
    den = max(np.sum(u_exact[valid] ** 2), np.finfo(float).eps)
    return float(np.sqrt(num / den))


def _host(a) -> np.ndarray:
    """Host float64 copy of a state component (torch tensor or array)."""
    if hasattr(a, "detach"):
        a = a.detach().cpu().double().numpy()
    return np.asarray(a, np.float64)


def make_postprocess_data(cfg, scene, state, profile_times, mid_profile_u,
                          result_png: str, profile_png: str,
                          full_profile_u=None) -> dict:
    """Bundle everything the standalone postprocess needs
    (reference: make_postprocess_data, SPH_Poiseuille.m:617-640).

    ``full_profile_u`` ((n_bins, n_outputs), optional): the full-channel
    binned profile at every output point — enables the time-averaged L2
    metric (this framework's addition; the instantaneous final-state L2
    carries a ~0.2-0.5 pp acoustic oscillation between output points,
    docs/VALIDATION.md)."""
    nf = scene.n_fluid
    x = np.mod(_host(state.x[:nf]), cfg.DL)
    y = _host(state.y[:nf])
    u = _host(state.vx[:nf])
    v = _host(state.vy[:nf])
    y_mid, u_mean = binned_profile_mean(y, u, 0.0, cfg.DH, cfg.n_bins)
    u_exact = cfg.analytic_u(y_mid)
    return {
        "cfg_DL": cfg.DL, "cfg_DH": cfg.DH, "cfg_dp": cfg.dp,
        "cfg_U_max": cfg.U_max, "cfg_gravity_g": cfg.gravity_g,
        "cfg_nu": cfg.nu, "cfg_h": cfg.h,
        "cfg_wall_thickness": cfg.wall_thickness,
        "n_fluid": nf,
        "fluid_x": x, "fluid_y": y, "fluid_u": u, "fluid_v": v,
        "n_bins": cfg.n_bins,
        "profile_times": np.asarray(profile_times, np.float64),
        "mid_profile_u": np.asarray(mid_profile_u, np.float64),
        "y_mid": y_mid, "u_mean": u_mean, "u_exact": u_exact,
        "result_png": result_png, "profile_evolution_png": profile_png,
        **({} if full_profile_u is None
           else {"full_profile_u": np.asarray(full_profile_u, np.float64)}),
    }


def save_postprocess_npz(path: str, data: dict):
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    np.savez(path, **data)


def load_postprocess_npz(path: str) -> dict:
    """Schema-validated load. The final profile (y_mid/u_mean/u_exact) is
    NOT required — ``get_final_profile`` reconstructs it from the raw state
    when absent (reference: get_final_profile,
    SPH_Poiseuille_postprocess.m:158-175)."""
    if not os.path.exists(path):
        raise FileNotFoundError(f"postprocess data file does not exist: {path}")
    with np.load(path, allow_pickle=False) as z:
        required = ("cfg_DL", "cfg_DH", "cfg_dp", "cfg_U_max",
                    "cfg_gravity_g", "cfg_nu", "cfg_h",
                    "cfg_wall_thickness", "n_fluid", "fluid_x",
                    "fluid_y", "fluid_u", "n_bins", "profile_times",
                    "mid_profile_u", "result_png", "profile_evolution_png")
        missing = [k for k in required if k not in z]
        if missing:
            raise ValueError(f"postprocess data missing fields: {missing}")
        return {k: z[k] for k in z.files}


def get_final_profile(data: dict):
    """(y_mid, u_mean, u_exact): stored when present, otherwise
    reconstructed from the raw final state — the reference's fallback for
    handoff files without a final_profile struct
    (SPH_Poiseuille_postprocess.m:158-175)."""
    if all(k in data for k in ("y_mid", "u_mean", "u_exact")):
        return (np.asarray(data["y_mid"], np.float64),
                np.asarray(data["u_mean"], np.float64),
                np.asarray(data["u_exact"], np.float64))
    DH = float(data["cfg_DH"])
    y = np.asarray(data["fluid_y"], np.float64)
    u = np.asarray(data["fluid_u"], np.float64)
    n_bins = int(data["n_bins"])
    y_mid, u_mean = binned_profile_mean(y, u, 0.0, DH, n_bins)
    g = float(data["cfg_gravity_g"])
    nu = float(data["cfg_nu"])
    u_exact = g / (2.0 * nu) * y_mid * (DH - y_mid)
    return y_mid, u_mean, u_exact


def edge_seam_metrics(data: dict, half_width: Optional[float] = None):
    """Periodic-seam regression canaries matching the reference's published
    fix-log metrics (README.md:150-151: ``edge ux gap`` 0.0232 and ``edge
    profile L2`` 0.00514 after the ghost-entry fix). The reference does not
    ship the computation, so the definitions here are documented:

    * left/right edge profiles over the slices ``x in [0, w)`` and
      ``x in (DL - w, DL]`` with ``w = max(dp, h)`` (the mid-channel
      monitor's slice width, SPH_Poiseuille.m:593);
    * ``edge_ux_gap`` = max over common non-empty bins of
      ``|d_left(y) - d_right(y)|`` where ``d = u_x - u_exact(y)`` is binned
      PER PARTICLE — the seam discontinuity. Binning the analytic
      deviation rather than raw u removes the intra-bin sampling noise
      (one edge column holds ~1 particle per bin, so raw-u bin means
      differ by (du/dy) x intra-bin y scatter even for a perfectly
      continuous field);
    * ``edge_profile_L2`` = relative L2 vs the analytic profile of the
      COMBINED seam slice (periodic distance to x=0 within w) — the L2 of
      the profile the seam fix is supposed to make continuous.
    """
    DL = float(data["cfg_DL"])
    DH = float(data["cfg_DH"])
    if half_width is None:
        half_width = max(float(data["cfg_dp"]), float(data["cfg_h"]))
    x = np.mod(np.asarray(data["fluid_x"], np.float64), DL)
    y = np.asarray(data["fluid_y"], np.float64)
    u = np.asarray(data["fluid_u"], np.float64)
    n_bins = int(data["n_bins"])
    g = float(data["cfg_gravity_g"])
    nu = float(data["cfg_nu"])

    dev = u - g / (2.0 * nu) * y * (DH - y)
    left = x < half_width
    right = x > DL - half_width
    _, d_left = binned_profile_mean(y[left], dev[left], 0.0, DH, n_bins)
    _, d_right = binned_profile_mean(y[right], dev[right], 0.0, DH, n_bins)
    both = ~np.isnan(d_left) & ~np.isnan(d_right)
    edge_ux_gap = (float(np.max(np.abs(d_left[both] - d_right[both])))
                   if np.any(both) else float("nan"))

    y_mid, u_seam = mid_channel_profile(x, y, u, DL, DH, 0.0, half_width,
                                        n_bins)
    u_exact = g / (2.0 * nu) * y_mid * (DH - y_mid)
    edge_profile_l2 = compute_l2_error(u_seam, u_exact)
    return edge_ux_gap, edge_profile_l2


TIME_AVG_WINDOW = 5.0  # seconds of trailing outputs averaged for the
#                        time-averaged L2 (matches the oracle-study window,
#                        docs/VALIDATION.md)


def time_averaged_l2(data: dict,
                     window: float = TIME_AVG_WINDOW) -> Optional[float]:
    """L2 of the TIME-AVERAGED full-channel profile over the trailing
    ``window`` seconds of output points (always including the final one).

    The instantaneous final-state L2 oscillates by a few tenths of a
    percentage point between output points (the weakly-compressible
    acoustic field); averaging the binned profile first removes that
    component and measures the steady-state bias alone. The window is
    capped at 25% of the run length so short (still-developing) runs
    don't average their startup transient into the verdict — there it
    degrades gracefully toward the instantaneous L2. Returns None when
    the handoff predates the ``full_profile_u`` field."""
    if "full_profile_u" not in data:
        return None
    fp = np.asarray(data["full_profile_u"], np.float64)
    tvals = np.asarray(data["profile_times"], np.float64).ravel()
    if fp.ndim != 2 or fp.shape[1] != tvals.size or tvals.size == 0:
        return None
    window = min(window, 0.25 * (tvals[-1] - tvals[0]))
    sel = tvals >= tvals[-1] - window
    sel[-1] = True
    with warnings.catch_warnings():
        # bins empty at EVERY selected output produce all-NaN rows; keep
        # them NaN (compute_l2_error drops empty bins) without the warning
        warnings.simplefilter("ignore", category=RuntimeWarning)
        avg = np.nanmean(fp[:, sel], axis=1)
    y_mid, _, u_exact = get_final_profile(data)
    return compute_l2_error(avg, u_exact)


def _interp_velocity_field(x, y, u, cfg_DL, cfg_DH, cfg_dp, cfg_h):
    """Interpolate u_x onto a 2x-resolution grid, extending points across
    the periodic seam (reference: build_velocity_field_grid,
    SPH_Poiseuille_postprocess.m:184-201)."""
    from scipy.interpolate import griddata

    nx_grid = int(round(cfg_DL / cfg_dp)) * 2
    ny_grid = int(round(cfg_DH / cfg_dp)) * 2
    xg = np.linspace(0, cfg_DL, nx_grid)
    yg = np.linspace(0, cfg_DH, ny_grid)
    Xg, Yg = np.meshgrid(xg, yg)

    right = x > cfg_DL - 2 * cfg_h
    left = x < 2 * cfg_h
    xe = np.concatenate([x, x[right] - cfg_DL, x[left] + cfg_DL])
    ye = np.concatenate([y, y[right], y[left]])
    ue = np.concatenate([u, u[right], u[left]])
    pts = np.stack([xe, ye], axis=1)
    Ug = griddata(pts, ue, (Xg, Yg), method="linear")
    nearest = griddata(pts, ue, (Xg, Yg), method="nearest")
    Ug = np.where(np.isnan(Ug), nearest, Ug)
    return xg, yg, Ug


def run_postprocess(data: dict, quiet: bool = False) -> dict:
    """Produce the L2 verdict + both figures. Returns
    {L2_error, passed, result_png, profile_evolution_png}."""
    DL = float(data["cfg_DL"])
    DH = float(data["cfg_DH"])
    U_max = float(data["cfg_U_max"])
    wall_thickness = float(data["cfg_wall_thickness"])
    y_mid, u_mean, u_exact = get_final_profile(data)
    result_png = str(data["result_png"])
    profile_png = str(data["profile_evolution_png"])

    l2 = compute_l2_error(u_mean, u_exact)
    passed = l2 < L2_PASS_THRESHOLD
    edge_ux_gap, edge_profile_l2 = edge_seam_metrics(data)
    l2_avg = time_averaged_l2(data)
    if not quiet:
        print(f"L2 relative error = {100.0 * l2:.4f}%")
        if l2_avg is not None:
            print(f"L2 (time-averaged profile, last {TIME_AVG_WINDOW:g} s) "
                  f"= {100.0 * l2_avg:.4f}%")
        print("validation PASSED: L2_error < 5%" if passed
              else "validation FAILED: L2_error >= 5%")
        print(f"edge ux gap = {edge_ux_gap:.4f}")
        print(f"edge profile L2 = {edge_profile_l2:.5f}")
    result = {"L2_error": l2, "passed": passed,
              "L2_time_avg": l2_avg,
              "edge_ux_gap": edge_ux_gap, "edge_profile_L2": edge_profile_l2,
              "result_png": result_png,
              "profile_evolution_png": profile_png}
    try:
        import matplotlib
        import scipy.interpolate  # noqa: F401  (heatmap interpolation)
    except ImportError as e:
        print(f"figures skipped: {e.name} is not installed")
        return result
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    os.makedirs(os.path.dirname(result_png) or ".", exist_ok=True)
    os.makedirs(os.path.dirname(profile_png) or ".", exist_ok=True)

    y_norm = y_mid / DH
    u_norm_exact = u_exact / U_max
    u_norm_sph = u_mean / U_max

    # --- figure 1: profile + velocity field ---
    fig, (ax1, ax2) = plt.subplots(1, 2, figsize=(14, 5.2))
    ax1.plot(u_norm_exact, y_norm, "-", color="0.1", lw=1.8,
             label="Analytical")
    ax1.plot(u_norm_sph, y_norm, "o", color=(0.85, 0.2, 0.2), ms=5,
             label="SPH")
    ax1.set_xlabel(r"$u_x / U_{max}$")
    ax1.set_ylabel(r"$y / H$")
    ax1.set_xlim(-0.05, 1.15)
    ax1.set_ylim(0, 1)
    ax1.legend(loc="lower right", frameon=False)
    ax1.text(0.05, 0.95, rf"$L_2 = {100 * l2:.2f}\%$",
             transform=ax1.transAxes, va="top")
    ax1.set_title("(a) Velocity profile")

    xg, yg, Ug = _interp_velocity_field(
        np.asarray(data["fluid_x"]), np.asarray(data["fluid_y"]),
        np.asarray(data["fluid_u"]), DL, DH, float(data["cfg_dp"]),
        float(data["cfg_h"]))
    y_lo, y_hi = -wall_thickness, DH + wall_thickness
    ax2.fill_between([0, DL], y_lo, 0, color="0.75")
    ax2.fill_between([0, DL], DH, y_hi, color="0.75")
    im = ax2.imshow(Ug, extent=[0, DL, 0, DH], origin="lower",
                    aspect="equal", cmap="turbo", vmin=0,
                    vmax=U_max * 1.1)
    ax2.axhline(0, color="k", lw=1.2)
    ax2.axhline(DH, color="k", lw=1.2)
    ax2.text(DL / 2, y_lo / 2, "Wall", ha="center", color="0.3")
    ax2.text(DL / 2, DH + wall_thickness / 2, "Wall", ha="center",
             color="0.3")
    ax2.set_xlim(0, DL)
    ax2.set_ylim(y_lo, y_hi)
    ax2.set_xlabel("$x$ (m)")
    ax2.set_ylabel("$y$ (m)")
    cb = fig.colorbar(im, ax=ax2)
    cb.set_label(r"$u_x$ (m/s)")
    ax2.set_title("(b) Velocity field")
    fig.savefig(result_png, dpi=110, bbox_inches="tight")
    plt.close(fig)
    if not quiet:
        print(f"result figure saved: {result_png}")

    # --- figure 2: mid-channel profile evolution ---
    # styling twin of SPH_Poiseuille_postprocess.m:84-126: parula(n) line
    # colors, serif (Times) fonts, box on, inward ticks, dashed analytic
    fig2, ax = plt.subplots(figsize=(7.6, 5.6))
    tvals = np.asarray(data["profile_times"], np.float64).ravel()
    mid_u = np.asarray(data["mid_profile_u"], np.float64)
    n_profiles = tvals.size
    cmap = parula_cmap(max(n_profiles, 2))
    for k in range(n_profiles):
        u_k = mid_u[:, k] / U_max
        ok = ~np.isnan(u_k)
        if np.any(ok):
            ax.plot(u_k[ok], y_mid[ok] / DH, "-",
                    color=cmap(k / max(n_profiles - 1, 1)), lw=1.0)
    ax.plot(u_norm_exact, y_norm, "--", color="0.1", lw=1.6)
    # first installed serif wins (the reference uses Times New Roman;
    # resolving up front avoids per-text findfont warnings on hosts
    # without it)
    from matplotlib import font_manager
    installed = {f.name for f in font_manager.fontManager.ttflist}
    serif = next((f for f in ("Times New Roman", "Liberation Serif",
                              "DejaVu Serif") if f in installed),
                 "serif")
    ax.set_xlabel(r"$u_x / U_{max}$", fontsize=14)
    ax.set_ylabel(r"$y / H$", fontsize=14)
    ax.set_xlim(-0.05, 1.15)
    ax.set_ylim(0, 1)
    ax.set_title("(c) Mid-channel profile evolution", fontsize=13,
                 fontfamily=serif, fontweight="normal")
    ax.tick_params(direction="in", length=4.5, labelsize=13)
    for lbl in ax.get_xticklabels() + ax.get_yticklabels():
        lbl.set_fontfamily(serif)
    for side in ax.spines.values():
        side.set_linewidth(1.0)
    t_min, t_max = (float(tvals.min()), float(tvals.max())) \
        if n_profiles else (0.0, 1.0)
    if t_max <= t_min:
        t_max = t_min + 1.0
    sm = plt.cm.ScalarMappable(cmap=cmap,
                               norm=plt.Normalize(t_min, t_max))
    cb2 = fig2.colorbar(sm, ax=ax)
    cb2.set_label("$t$ (s)", fontsize=12)
    cb2.ax.tick_params(direction="in", labelsize=11)
    for lbl in cb2.ax.get_yticklabels():
        lbl.set_fontfamily(serif)
    cb2.outline.set_linewidth(1.0)
    fig2.savefig(profile_png, dpi=110, bbox_inches="tight")
    plt.close(fig2)
    if not quiet:
        print(f"profile-evolution figure saved: {profile_png}")
    return result


def postprocess_file(path: str, quiet: bool = False) -> dict:
    """Standalone entry point: load handoff npz, produce figures + verdict
    (reference: SPH_Poiseuille_postprocess.m:1-132)."""
    return run_postprocess(load_postprocess_npz(path), quiet=quiet)
