"""The port's RNS tower, ``ntt_tpu_torch.rns.DeviceRnsTower``, built for a
configuration: one ``api.DeviceNtt`` a listed prime, all at the
configuration's N, their tables on the cell's home card (the first of
its devices; the tower uses no other).  The traffic's ``entry`` names the
tower method a step calls."""

from __future__ import annotations

import time

import torch


def build(config: dict, devices: list[torch.device]) -> tuple[object, dict[str, float]]:
    """(the tower, {"library_s", "tables_s"}): the seconds to build or load
    the kernel library from its cache in the checkout, and to make the
    tower's plans and put their tables on the device."""
    from ntt_tpu_torch import native, rns
    from ntt_tpu_torch.params import NttParams

    device = devices[0]
    t0 = time.perf_counter()
    if device.type == "cuda":
        native.lib()
    t1 = time.perf_counter()
    m = config["log_n"]
    params = [NttParams.make(int(q, 16), m) for q in config["moduli"]]
    tower = rns.DeviceRnsTower(m, params=params, device=device)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    t2 = time.perf_counter()
    return tower, {"library_s": t1 - t0, "tables_s": t2 - t1}
