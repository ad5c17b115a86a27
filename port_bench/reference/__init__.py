"""The plain fp32 reference of the benchmark's comparison.

A frozen copy of the SAM 2.1 modules in plain PyTorch (``configs``,
``layers``, ``hiera``, ``image_encoder``, ``position_encoding``,
``prompt_encoder``, ``mask_decoder``, ``transformer``, ``memory_attention``,
``memory_encoder``, ``sam2_base``), cv2's float INTER_LINEAR rebuilt in
numpy (``cv2_resize``), and, written for the benchmark, the video tracking
of one object row with a plain frame-indexed memory (``tracker``) and hole
filling with scipy's labeller (``holes``). Nothing here imports the program
under test, and it takes nothing the program made: the harness hands it the
weights, frames and prompts it hands the program.
"""
