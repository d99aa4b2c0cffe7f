"""How the benchmark drives each problem family of the port, one module a
family, named by a configuration file's ``family``."""
