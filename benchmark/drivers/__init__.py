"""One driver per kind of traffic: `run(job)` and `control_numbers(job)`."""
