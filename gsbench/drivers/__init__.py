"""The loops that drive the program, one module a traffic file's
``driver``, found by name. A module gives ``run(run)``: it builds the
cell's inputs from the seed, warms the program up, closes the set-up,
measures the window, and fills in the run's metrics and compared
numbers (``bench.Run``)."""
