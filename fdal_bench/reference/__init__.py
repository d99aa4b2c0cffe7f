"""Plain reference of the benchmark's configurations: each rebuilds, in
float64 and from the configuration file and the request's data alone, the
system that the configuration states, and measures an answer's residual in
it.  It imports nothing of the program (neither package of this
repository)."""
