"""The notebook walkthrough (counterpart of the repository's ``examples/``):
``python -m ab_opt_tpu_torch.examples.ab_opt_pipeline`` (poses, designs,
screening) and ``python -m ab_opt_tpu_torch.examples.ab_opt_analysis``
(the screening analysis)."""
