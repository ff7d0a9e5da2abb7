from repro_torch.serving.admission import (AdmissionController,
                                           AdmissionDecision, DEFAULT_TIERS,
                                           TierSpec)
from repro_torch.serving.engine import (ArrivalPredictor, ServeReport,
                                        ServingEngine, Tenant)
from repro_torch.serving.frontdoor import (DoorClosed, FrontDoor,
                                           MonotonicClock, Ticket,
                                           VirtualClock)
from repro_torch.serving.workload import (ServeRequest, bursty_arrivals,
                                          diurnal_arrivals, long_prompt_trace,
                                          make_trace, open_loop_trace,
                                          poisson_arrivals, two_wave_trace)

__all__ = [
    "AdmissionController", "AdmissionDecision", "ArrivalPredictor",
    "DEFAULT_TIERS", "DoorClosed", "FrontDoor", "MonotonicClock",
    "ServeReport", "ServeRequest", "ServingEngine", "Tenant", "Ticket",
    "TierSpec", "VirtualClock",
    "bursty_arrivals", "diurnal_arrivals", "long_prompt_trace", "make_trace",
    "open_loop_trace", "poisson_arrivals", "two_wave_trace",
]
