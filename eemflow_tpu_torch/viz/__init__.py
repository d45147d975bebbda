"""Flow and event pictures of the port (counterpart of ``eemflow_tpu/viz``):
colour codes, the research visualizers and the train-loop hook, written as
PNG by ``viz.png`` (numpy and ``zlib``)."""

from eemflow_tpu_torch.viz.flow_viz import events_to_event_image, flow_to_image, visualize_optical_flow
