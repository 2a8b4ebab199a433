"""The port's dataset entry points, one module for each of the JAX
package's ``examples/*.py`` scripts, with the same arguments and output
files:

    python -m orb_slam3_detailed_comments_tpu_torch.examples.<name> \\
        <settings.yaml> <sequence_dir>... [<out.txt>] [--device cpu]

They run on the CUDA card; ``--device cpu`` runs the plain PyTorch path
on the CPU, and without a card and without that flag they fail. Each
module's ``main(argv)`` takes the arguments after the program name and
returns the exit code. ``runner`` holds what the scripts share;
``ros/`` holds the ROS nodes' launchers.
"""
