"""Quickstart: solve the paper's core problem in 30 lines, the counterpart
of the reference's ``examples/quickstart.py`` (host only: no device, no
model; its output equals the reference example's).

Given profiled ResNet variants, a latency SLO and a CPU budget, InfAdapter
picks a *set* of variants + allocations + traffic quotas maximizing
α·accuracy − (β·cost + γ·loading) — and beats the best single-variant choice.

Run:  PYTHONPATH=src python -m repro_torch.launch.quickstart
"""
from repro_torch.core.profiles import paper_resnet_profiles
from repro_torch.core.solver import solve_exact, solve_single_variant

SLO_MS = 750.0
BUDGET = 14          # CPU cores
LOAD = 75.0          # requests/second (paper Fig. 2 scenario)


def main():
    profiles = paper_resnet_profiles()

    inf = solve_exact(profiles, LOAD, BUDGET, SLO_MS, beta=0.05, gamma=0.01)
    ms = solve_single_variant(profiles, LOAD, BUDGET, SLO_MS, beta=0.05,
                              gamma=0.01)

    print(f"load={LOAD} RPS, budget={BUDGET} cores, SLO={SLO_MS} ms P99\n")
    print("InfAdapter (variant set):")
    for m, n in sorted(inf.units.items()):
        if n:
            print(f"  {m:10s} cores={n:2d} quota={inf.quotas.get(m, 0):5.1f} "
                  f"RPS (p99={profiles[m].p99_ms(n):.0f} ms)")
    print(f"  weighted accuracy = {inf.aa:.2f}%  cost = {inf.rc:.0f} cores")
    print("\nModel-Switching+ (best single variant):")
    for m, n in sorted(ms.units.items()):
        if n:
            print(f"  {m:10s} cores={n:2d}")
    print(f"  accuracy = {ms.aa:.2f}%  cost = {ms.rc:.0f} cores")
    print(f"\nInfAdapter accuracy gain: +{inf.aa - ms.aa:.2f}% at equal "
          f"SLO/budget")
    if inf.aa < ms.aa:
        raise AssertionError("the variant set lost to the single variant")


if __name__ == "__main__":
    main()
