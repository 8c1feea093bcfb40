"""A test-only architecture: the U-Net with weights drawn from the seed in
its ``model.init_seed``, no distillation. Found by name like any other
architecture, it shows that a configuration's model is new files only."""

from benchmark.harness import HERE, load_module
from benchmark.unet_ref import state_dict_of

_unet = load_module([HERE], "archs", "UNet")
write_checkpoint = _unet.write_checkpoint
forward_flops = _unet.forward_flops


def make_state(config, device):
    return state_dict_of(_unet.init_plain_unet(config["model"], config["model"]["init_seed"], device)), None
