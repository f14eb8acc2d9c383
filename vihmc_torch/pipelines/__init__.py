"""Flat-vector closures and MH delta evaluators (counterpart of ``vihmc_tpu.pipelines.common``)."""
