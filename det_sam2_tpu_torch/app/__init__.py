"""The Det-SAM2 application: detector self-prompting, the billiards
postprocessor, the asynchronous pipeline and its evaluation."""
