"""The port's benchmark harness: finds cells, configurations, mixes,
drivers, readers and references by name (`registry`), times and traces the
window (`trace`), prices kernels (`roofline`), makes inputs from the seed
(`inputs`) and judges `correct` (`judge`)."""
