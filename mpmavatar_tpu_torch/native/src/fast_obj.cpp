// Fast OBJ parser (vertices + triangle faces).
//
// Native replacement for the reference's python OBJ readers
// (utils/general_utils.py:318-335,
//  utils/smplx_deformer.py:37-57), which are a hot path when the eval
// stage re-reads hundreds of simulated meshes
// (train_material_params.py:828-832).  Exposed via ctypes: two-pass
// (count, then fill caller-allocated buffers).

#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <cstdint>

extern "C" {

// Returns 0 on success; fills n_verts/n_faces.
int obj_count(const char* path, int64_t* n_verts, int64_t* n_faces) {
    FILE* f = fopen(path, "rb");
    if (!f) return -1;
    char line[8192];
    int64_t nv = 0, nf = 0;
    while (fgets(line, sizeof(line), f)) {
        if (line[0] == 'v' && line[1] == ' ') nv++;
        else if (line[0] == 'f' && line[1] == ' ') nf++;
    }
    fclose(f);
    *n_verts = nv;
    *n_faces = nf;
    return 0;
}

// verts: (n_verts*3) float32, faces: (n_faces*3) int32 (0-based).
int obj_read(const char* path, float* verts, int32_t* faces) {
    FILE* f = fopen(path, "rb");
    if (!f) return -1;
    char line[8192];
    int64_t vi = 0, fi = 0;
    while (fgets(line, sizeof(line), f)) {
        if (line[0] == 'v' && line[1] == ' ') {
            char* p = line + 2;
            for (int k = 0; k < 3; k++) {
                verts[vi * 3 + k] = strtof(p, &p);
            }
            vi++;
        } else if (line[0] == 'f' && line[1] == ' ') {
            char* p = line + 2;
            for (int k = 0; k < 3; k++) {
                while (*p == ' ') p++;
                long idx = strtol(p, &p, 10);
                faces[fi * 3 + k] = (int32_t)(idx - 1);
                // skip texture/normal refs "/t/n"
                while (*p && *p != ' ' && *p != '\n') p++;
            }
            fi++;
        }
    }
    fclose(f);
    return 0;
}

}  // extern "C"
