"""DARTS: differentiable architecture search (port of ``katib_tpu.nas.darts``)."""
