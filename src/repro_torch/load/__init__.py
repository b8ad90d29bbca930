"""repro_torch.load — the workload plane (DESIGN.md Sec. 10).

Open-loop traffic for the protocol, DDS, and serve planes: seeded
arrival generators (:mod:`~repro_torch.load.arrivals`), staged ramp
profiles (:mod:`~repro_torch.load.profiles`), admission/shed policies
lowering to SMC window backpressure (:mod:`~repro_torch.load.admission`),
per-message tail-latency accounting from round traces
(:mod:`~repro_torch.load.metrics`), and the harness tying them together
(:mod:`~repro_torch.load.harness`)::

    from repro_torch.load import Poisson, WindowSlack, staged_ramp, run_profile

    profile = staged_ramp(Poisson(rate=0.5), overload=5.0, seed=0)
    report = run_profile(api.Group(cfg), profile,
                         admission=WindowSlack(queue_cap=32))
    report.stage("overload").p99_rounds   # bounded by the policy
"""

from repro_torch.load.admission import (AdmissionPolicy, AdmitAll,
                                        ServeAdmission, TokenBucket,
                                        WindowSlack)
from repro_torch.load.arrivals import (ArrivalSpec, Diurnal, OnOff, Poisson,
                                       Trace)
from repro_torch.load.harness import run_profile
from repro_torch.load.metrics import (LoadReport, StageStats, StageTally,
                                      build_report, delivered_watermark,
                                      sender_app_timeline)
from repro_torch.load.profiles import Profile, Stage, staged_ramp

__all__ = [
    "AdmissionPolicy", "AdmitAll", "ArrivalSpec", "Diurnal",
    "LoadReport", "OnOff", "Poisson", "Profile", "ServeAdmission",
    "Stage", "StageStats", "StageTally", "TokenBucket", "Trace",
    "WindowSlack", "build_report", "delivered_watermark", "run_profile",
    "sender_app_timeline", "staged_ramp",
]
