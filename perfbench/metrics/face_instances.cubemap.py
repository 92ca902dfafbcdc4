"""The program's binned instances a traced cubemap step over its five
faces: the counts its `StepMetrics.face_instances` reports, which the
cubemap driver records in the first traced segment and averages over its
steps. None where the program reports none."""


def read(run):
    if run.driver != "train" or not run.traced_steps:
        return None
    return run.work.get("face_instances")
