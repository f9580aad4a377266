"""The comparison that decides `correct` for fit answers.

Each answer of the program (a fitted item) is held against the reference
fit of the same data.  Five numbers an answer; a cell compares those its
workloads/<cell>.json gives a limit:

  param_sigma   the largest gap of a fitted parameter (phi moved to the
                reference's nu_DM with the answer's DM, log10 tau moved to
                its nu_tau with the answer's alpha, DM, alpha), in the
                reference's sigmas;
  err_rel       the largest relative gap of a fitted parameter's error
                (sqrt(cov_ii) against the reference's);
  cov_rel       the largest gap of a fitted covariance entry over
                sqrt(cov_ii cov_jj) of the reference;
  nu_rel        the largest relative gap of nu_DM (and nu_tau);
  red_chi2_abs  the gap of the reduced chi2.
"""

import torch

def numbers(prog, ref, kdm, fit_flags):
    """{name: (B,) float64} for answers prog (a dict of params (B, 5),
    cov (B, 5, 5), nu_DM, nu_tau, red_chi2 (B,)) against the reference
    fit ref of the same items."""
    ff = torch.tensor([bool(f) for f in fit_flags])
    p = prog["params"].double()
    r = ref.params.double()
    d = torch.zeros_like(p)
    phi = p[:, 0] + kdm * p[:, 1] * (ref.nu_DM ** -2.0 -
                                     prog["nu_DM"].double() ** -2.0)
    d[:, 0] = phi - r[:, 0]
    d[:, 0] -= torch.round(d[:, 0])
    d[:, 1:] = p[:, 1:] - r[:, 1:]
    nus = [(prog["nu_DM"].double() - ref.nu_DM).abs() / ref.nu_DM]
    if fit_flags[3]:
        d[:, 3] = p[:, 3] + p[:, 4] * torch.log10(
            ref.nu_tau / prog["nu_tau"].double()) - r[:, 3]
        nus.append((prog["nu_tau"].double() - ref.nu_tau).abs() / ref.nu_tau)
    sig = ref.errs.double()
    zs = (d.abs() / torch.where(sig > 0, sig, 1.0))[:, ff]
    s = torch.where(ff, sig, 1.0)
    dc = (prog["cov"].double() - ref.cov.double()) / (s[:, :, None] *
                                                      s[:, None, :])
    dc = dc[:, ff][:, :, ff].abs()
    err = torch.diagonal(prog["cov"].double(), dim1=-2, dim2=-1).sqrt()
    de = ((err - sig).abs() / s)[:, ff]
    return {"param_sigma": zs.amax(-1),
            "err_rel": de.amax(-1),
            "cov_rel": dc.flatten(1).amax(-1),
            "nu_rel": torch.stack(nus).amax(0),
            "red_chi2_abs": (prog["red_chi2"].double() -
                             ref.red_chi2.double()).abs()}


def judge(nums, limits):
    """(failed (B,) bool, {name: largest number}) over the numbers that
    limits names: an answer fails when any of them exceeds its limit, or
    is not finite."""
    failed = torch.zeros_like(nums["param_sigma"], dtype=torch.bool)
    worst = {}
    for name in limits:
        v = nums[name]
        failed |= ~(v <= limits[name])
        worst[name] = float(torch.where(torch.isfinite(v), v,
                                        torch.inf).max())
    return failed, worst
