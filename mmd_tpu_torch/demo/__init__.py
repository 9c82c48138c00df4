"""The claim-verification demo (counterparts of mmd_tpu/demo): the
five-step pipeline, its static HTML report and the streamlit page."""
