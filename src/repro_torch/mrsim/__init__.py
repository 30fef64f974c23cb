from .simulator import (APPS, JobParams, iter_cpu_series, paper_param_sets,
                        simulate_cpu_series, simulate_cpu_series_uncertain)

__all__ = ["APPS", "JobParams", "simulate_cpu_series",
           "simulate_cpu_series_uncertain", "iter_cpu_series",
           "paper_param_sets"]
