from .simulator import (APPS, JobParams, iter_cpu_series, paper_param_sets,
                        simulate_cpu_series)

__all__ = ["APPS", "JobParams", "simulate_cpu_series", "iter_cpu_series",
           "paper_param_sets"]
