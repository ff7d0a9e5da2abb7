from repro_torch.serving.engine import (ArrivalPredictor, ServeReport,
                                        ServingEngine, Tenant)
from repro_torch.serving.workload import (ServeRequest, bursty_arrivals,
                                          diurnal_arrivals, long_prompt_trace,
                                          make_trace, open_loop_trace,
                                          poisson_arrivals, two_wave_trace)

__all__ = [
    "ArrivalPredictor", "ServeReport", "ServeRequest", "ServingEngine",
    "Tenant", "bursty_arrivals", "diurnal_arrivals", "long_prompt_trace",
    "make_trace", "open_loop_trace", "poisson_arrivals", "two_wave_trace",
]
