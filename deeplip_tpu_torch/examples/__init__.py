"""The port's walkthroughs: the full pipeline on a synthetic corpus
(``full_pipeline_demo``) and the serving API (``verify_demo``)."""
