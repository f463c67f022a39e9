"""Example scripts (ports of the JAX package's ``examples/``), each runnable
as ``python -m rgp_tpu_torch.examples.<name>`` and callable as
``main(argv)``, which returns what the script printed as JSON:

* ``actuator_rgp``: config 1, a 1-layer RGP on actuator, Adam, free simulation;
* ``drives_deep_rgp``: config 2, a 2-layer RGP on drives (``--back-cstr``);
* ``minibatch_svgp``: config 4, minibatch SVI with natural-gradient q(u);
* ``nuts_smc_demo``: config 5, NUTS over the hyperparameters and SMC over
  latent trajectories;
* ``evidence_tempered_smc``: two RGP variants compared by tempered-SMC
  log-evidence.

Each keeps its JAX twin's arguments and the keys of what it prints, and adds
``--device`` (default ``cuda``) and ``--seed``.
"""
