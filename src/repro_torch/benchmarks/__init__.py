"""The paper's figures on the port (the counterpart of the top-level
``benchmarks`` package, which stays the reference's): one module per
figure, each ``run(quick=True, ..., device="cuda")`` printing
``name,us_per_call,derived`` rows and returning the reference's values.
State is drawn on ``device`` (``cuda`` unless the caller asks for
``cpu``); rows persisted to disk go to ``experiments/torch/``.
``python -m repro_torch.benchmarks.run`` runs them all."""
