"""One reader a metric, `read(run)`, which returns the number or None
where it finds nothing. Its name, unit, layer and cells are its entry in
BENCHMARK.json, the only registry."""
