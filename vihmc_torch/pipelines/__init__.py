"""The three stages' pipelines and their plumbing (counterpart of ``vihmc_tpu.pipelines``)."""
