"""Batched evaluations (the program's ``BaseMetric._run_prepared``) per
public call in the profiled stretch, counted by the benchmark's wrapper."""


def read(run):
    if not run.traced or not run.evals:
        return None
    return run.evals / len(run.traced)
