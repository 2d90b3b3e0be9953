"""Model families: what the yardstick knows of one architecture, a file
each (``families/<name>.py``), found by the ``family`` key of a
configuration file (``progen`` where the key is absent).

A family file holds:

* ``Spec``: the configuration's sizes, ``Spec.from_dict(raw)``, with
  ``parameter_shapes()`` (name, shape, kind of every parameter, named
  as the program's ``state_dict`` names them), ``num_params()``,
  ``seq_len``, ``remat`` and ``dtype``;
* ``SCALES``: kind -> (scale(shape, spec), shift) of the seeded
  weights (``weights.make``);
* ``KERNEL_NAMES``: kernel id -> the profiler's names of that
  hand-written kernel. A name belongs to one id in every family: a
  family that runs another family's kernel uses its id;
* ``flops_per_token(spec)``, ``work_ms(spec, rows, *, forwards,
  backwards)`` (kernel id -> the least time of that kernel's work, ms)
  and ``train_step_passes(spec, grad_accum)``;
* ``rows_nll(params, spec, rows, linear)``: the plain float32
  reference's per-sequence loss;
* ``program_train_state(raw, optimizer, device)``: the program's
  training state for the configuration, its parameters left for
  ``load_state_dict``.
"""
