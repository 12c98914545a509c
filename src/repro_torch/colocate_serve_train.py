"""The paper's end-to-end scenario on real models: a high-priority serving
engine (continuous batching) handles bursty traffic while a best-effort
training job consumes idle quanta — Tally's opportunistic policy at work,
observed by the telemetry hub (the port of
``examples/colocate_serve_train.py``).

    PYTHONPATH=src python -m repro_torch.colocate_serve_train
    PYTHONPATH=src python -m repro_torch.colocate_serve_train --device cpu

Add ``--chaos`` to inject a mid-run engine outage (queued requests blow
their per-request timeout) and ``--failover`` to arm the client-side
failover stack — timeout retries with deterministic backoff, hedged
requests, brownout degradation — so the outage degrades latency instead
of losing requests:

    PYTHONPATH=src python -m repro_torch.colocate_serve_train --chaos \
        --failover

Runs on the card unless ``--device cpu``, at the reduced width that
``repro_torch.launch.serve.serve`` runs.
"""
from __future__ import annotations

import argparse
import json
from typing import Tuple

from repro_torch.launch.serve import serve
from repro_torch.obs import ObsHub, prometheus_text


def colocate_serve_train(**serve_kw) -> Tuple[dict, ObsHub]:
    """The example's run: ``serve`` on qwen2.5-14b (12 requests, 4 slots,
    6 new tokens each, the trainer co-located) observed by a fresh
    ``ObsHub``; ``serve_kw`` are ``serve``'s keyword arguments (``chaos``,
    ``failover``, ``device``, ``timeout``, ``stall_s``, ...) and override
    the example's. Prints what the example prints and returns ``serve``'s
    result and the hub."""
    hub = ObsHub()        # live telemetry: per-request latency histograms
    kw = dict(requests=12, capacity=4, max_new_tokens=6,
              colocate_train=True, obs=hub)
    kw.update(serve_kw)
    out = serve("qwen2.5-14b", **kw)
    print(json.dumps(out, indent=1))
    print(f"\nserved {out['requests']} requests "
          f"(p99 {out['p99_ms']:.0f} ms on {out['device']}) while the "
          f"best-effort trainer completed {out['be_quanta']} quanta "
          f"in serving idle gaps")
    if kw.get("chaos"):
        print(f"chaos: {out['shed']} requests lost, "
              f"{out['retries']} timeout retries"
              + (" (failover on)" if kw.get("failover") else
                 " (failover off — rerun with --failover)"))
    lat = hub.registry.get("tally_serving_request_latency_seconds").child()
    ttft = hub.registry.get("tally_serving_ttft_seconds").child()
    print(f"registry view: {lat.count} requests, "
          f"latency p50≈{lat.quantile(0.5) * 1e3:.0f} ms "
          f"p99≈{lat.quantile(0.99) * 1e3:.0f} ms, "
          f"ttft p99≈{ttft.quantile(0.99) * 1e3:.0f} ms "
          f"(bucketed estimates)")
    text = prometheus_text(hub.registry)
    serving_lines = [ln for ln in text.splitlines()
                     if ln.startswith("tally_serving")
                     and ("_count" in ln or "_total" in ln or "slots" in ln)]
    print("\n".join(serving_lines))
    return out, hub


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--chaos", action="store_true",
                    help="inject a mid-run serving outage")
    ap.add_argument("--failover", action="store_true",
                    help="timeout retries + hedging + brownout")
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu")
    args = ap.parse_args(argv)
    colocate_serve_train(chaos=args.chaos, failover=args.failover,
                         device=args.device)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
