from cvsd_tpu_torch.viz.annotate import annotate_video, annotate_video_detections, draw_detections

__all__ = ["annotate_video", "annotate_video_detections", "draw_detections"]
