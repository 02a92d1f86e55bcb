"""How the harness serves each model family through the port: the sizes the
yardstick counts with (``dims``), the port's ``ModelConfig`` built from the
configuration file's published keys (``port_config``), and the weight tree
the benchmark draws (``weight_spec``: the port's parameter layout, which
the plain reference reads by the same names).  One module per family; the
harness finds it by the configuration's ``family`` key."""
