"""The port's command-line entry points: ``python -m
progen_tpu_torch.cli.<name>`` for generate_data, train, eval, sample and
serve.
Each module's ``run(argv)`` does the work and returns what it did;
``main(argv)`` is the console entry point around it."""
