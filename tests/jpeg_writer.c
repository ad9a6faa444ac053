/* jpeg_writer: libjpeg's encoder and decoder for the JPEG fixtures.
 *
 * Neither OpenCV nor Pillow writes arithmetic-coded files, scan scripts
 * that leave coefficients unfinished, 4x4-subsampled chroma or CMYK
 * without an Adobe marker; this program writes them with the system's
 * libjpeg(-turbo), and reads any JPEG back as libjpeg decodes it (from
 * memory, as the JAX package's native loader reads: a file that ends
 * early is decoded with libjpeg's fill). tests/jpeg_fixtures.py builds
 * it (gcc jpeg_writer.c -ljpeg) and drives it through pipes; the tests
 * read the committed fixtures and their manifest, not this program.
 *
 *   jpeg_writer encode W H C [options] < pixels > file.jpg
 *     C 3: RGB (or C 1: grey) pixels in; C 4: CMYK pixels in.
 *     -q Q            quality (default 90)
 *     -arith          arithmetic coding (SOF9, or SOF10 with -prog)
 *     -prog           progressive, libjpeg's default scan script
 *     -scans SPEC     a scan script: scans split by ';', each
 *                     "c,c,...:Ss-Se:Ah:Al" with component indexes c
 *     -samp H0xV0,H1xV1,...  sampling factors of each component
 *     -restart N      restart interval in MCUs
 *     -dac L,U,K      arithmetic conditioning of every table
 *     -ycck / -noadobe  (C 4) write YCCK, or CMYK without the Adobe marker
 *   jpeg_writer decode SCALE < file.jpg > out
 *     "W H C\n" then the rows: RGB for 1 or 3 components, CMYK for 4, at
 *     libjpeg's DCT scale SCALE/8. Exit status 1 when libjpeg fails; its
 *     warnings go to stderr, one a line.
 *   jpeg_writer coefwrite BW BH < table coefficients > file.jpg
 *     a greyscale baseline (16-bit table: SOF1) image of BW x BH blocks
 *     from its quantization table (64 uint16, natural order) and its
 *     quantized coefficients (int16, natural order, block rows): the
 *     IDCTs' extreme inputs.
 */
#include <setjmp.h>
#include <stdio.h>
#include <stdlib.h>
#include <string.h>

#include <jpeglib.h>

struct err_mgr {
    struct jpeg_error_mgr mgr;
    jmp_buf jb;
};

static void err_exit(j_common_ptr cinfo) {
    struct err_mgr* e = (struct err_mgr*)cinfo->err;
    (*cinfo->err->output_message)(cinfo);
    longjmp(e->jb, 1);
}

/* every warning, not only the first (jerror.c emit_message's default) */
static void emit_message(j_common_ptr cinfo, int msg_level) {
    if (msg_level < 0) {
        (*cinfo->err->output_message)(cinfo);
        cinfo->err->num_warnings++;
    }
}

static unsigned char* read_all(FILE* f, size_t* n) {
    size_t cap = 1 << 16, len = 0;
    unsigned char* buf = malloc(cap);
    size_t got;
    while ((got = fread(buf + len, 1, cap - len, f)) > 0) {
        len += got;
        if (len == cap) buf = realloc(buf, cap *= 2);
    }
    *n = len;
    return buf;
}

static int parse_scans(const char* spec, jpeg_scan_info* scans) {
    int n = 0;
    const char* p = spec;
    while (*p) {
        jpeg_scan_info* s = &scans[n++];
        memset(s, 0, sizeof(*s));
        for (;;) {
            s->component_index[s->comps_in_scan++] = (int)strtol(p, (char**)&p, 10);
            if (*p != ',') break;
            ++p;
        }
        if (sscanf(p, ":%d-%d:%d:%d", &s->Ss, &s->Se, &s->Ah, &s->Al) != 4)
            return -1;
        p = strchr(p, ';');
        if (!p) break;
        ++p;
    }
    return n;
}

static int encode(int argc, char** argv) {
    int w = atoi(argv[2]), h = atoi(argv[3]), c = atoi(argv[4]);
    int quality = 90, arith = 0, prog = 0, restart = 0, ycck = 0, noadobe = 0;
    int dac[3] = {-1, -1, -1}, nscans = 0, nsamp = 0, samp[4][2];
    static jpeg_scan_info scans[64];
    for (int i = 5; i < argc; ++i) {
        if (!strcmp(argv[i], "-q")) quality = atoi(argv[++i]);
        else if (!strcmp(argv[i], "-arith")) arith = 1;
        else if (!strcmp(argv[i], "-prog")) prog = 1;
        else if (!strcmp(argv[i], "-restart")) restart = atoi(argv[++i]);
        else if (!strcmp(argv[i], "-ycck")) ycck = 1;
        else if (!strcmp(argv[i], "-noadobe")) noadobe = 1;
        else if (!strcmp(argv[i], "-dac"))
            sscanf(argv[++i], "%d,%d,%d", &dac[0], &dac[1], &dac[2]);
        else if (!strcmp(argv[i], "-scans")) {
            nscans = parse_scans(argv[++i], scans);
            if (nscans <= 0) return 2;
        } else if (!strcmp(argv[i], "-samp")) {
            const char* p = argv[++i];
            while (nsamp < 4 && sscanf(p, "%dx%d", &samp[nsamp][0],
                                       &samp[nsamp][1]) == 2) {
                ++nsamp;
                p = strchr(p, ',');
                if (!p) break;
                ++p;
            }
        } else {
            return 2;
        }
    }
    size_t n;
    unsigned char* px = read_all(stdin, &n);
    if (n != (size_t)w * h * c) return 2;

    struct jpeg_compress_struct cinfo;
    struct err_mgr jerr;
    cinfo.err = jpeg_std_error(&jerr.mgr);
    jerr.mgr.error_exit = err_exit;
    if (setjmp(jerr.jb)) return 1;
    jpeg_create_compress(&cinfo);
    unsigned char* out = NULL;
    unsigned long out_len = 0;
    jpeg_mem_dest(&cinfo, &out, &out_len);
    cinfo.image_width = w;
    cinfo.image_height = h;
    cinfo.input_components = c;
    cinfo.in_color_space = c == 4 ? JCS_CMYK : (c == 3 ? JCS_RGB : JCS_GRAYSCALE);
    jpeg_set_defaults(&cinfo);
    if (c == 4) {
        jpeg_set_colorspace(&cinfo, ycck ? JCS_YCCK : JCS_CMYK);
        if (noadobe) cinfo.write_Adobe_marker = FALSE;
    }
    jpeg_set_quality(&cinfo, quality, TRUE);
    cinfo.arith_code = arith ? TRUE : FALSE;
    cinfo.optimize_coding = FALSE;
    cinfo.restart_interval = restart;
    for (int k = 0; k < nsamp && k < cinfo.num_components; ++k) {
        cinfo.comp_info[k].h_samp_factor = samp[k][0];
        cinfo.comp_info[k].v_samp_factor = samp[k][1];
    }
    if (dac[0] >= 0) {
        for (int t = 0; t < NUM_ARITH_TBLS; ++t) {
            cinfo.arith_dc_L[t] = (UINT8)dac[0];
            cinfo.arith_dc_U[t] = (UINT8)dac[1];
            cinfo.arith_ac_K[t] = (UINT8)dac[2];
        }
    }
    if (prog) jpeg_simple_progression(&cinfo);
    if (nscans) {
        cinfo.scan_info = scans;
        cinfo.num_scans = nscans;
    }
    jpeg_start_compress(&cinfo, TRUE);
    while (cinfo.next_scanline < cinfo.image_height) {
        JSAMPROW row = px + (size_t)cinfo.next_scanline * w * c;
        jpeg_write_scanlines(&cinfo, &row, 1);
    }
    jpeg_finish_compress(&cinfo);
    fwrite(out, 1, out_len, stdout);
    jpeg_destroy_compress(&cinfo);
    return 0;
}

static int decode(int argc, char** argv) {
    int scale = argc > 2 ? atoi(argv[2]) : 8;
    size_t n;
    unsigned char* buf = read_all(stdin, &n);
    struct jpeg_decompress_struct cinfo;
    struct err_mgr jerr;
    cinfo.err = jpeg_std_error(&jerr.mgr);
    jerr.mgr.error_exit = err_exit;
    jerr.mgr.emit_message = emit_message;
    if (setjmp(jerr.jb)) return 1;
    jpeg_create_decompress(&cinfo);
    jpeg_mem_src(&cinfo, buf, (unsigned long)n);
    jpeg_read_header(&cinfo, TRUE);
    cinfo.out_color_space = cinfo.num_components == 4 ? JCS_CMYK : JCS_RGB;
    cinfo.scale_num = scale;
    cinfo.scale_denom = 8;
    jpeg_start_decompress(&cinfo);
    const int w = cinfo.output_width, h = cinfo.output_height;
    const int c = cinfo.output_components;
    unsigned char* row = malloc((size_t)w * c);
    printf("%d %d %d\n", w, h, c);
    while (cinfo.output_scanline < cinfo.output_height) {
        jpeg_read_scanlines(&cinfo, &row, 1);
        fwrite(row, 1, (size_t)w * c, stdout);
    }
    jpeg_finish_decompress(&cinfo);
    jpeg_destroy_decompress(&cinfo);
    return 0;
}

static int coefwrite(int argc, char** argv) {
    const int bw = atoi(argv[2]), bh = atoi(argv[3]);
    size_t n;
    unsigned char* in = read_all(stdin, &n);
    if (n != 128 + (size_t)bw * bh * 128) return 2;
    struct jpeg_compress_struct cinfo;
    struct err_mgr jerr;
    cinfo.err = jpeg_std_error(&jerr.mgr);
    jerr.mgr.error_exit = err_exit;
    if (setjmp(jerr.jb)) return 1;
    jpeg_create_compress(&cinfo);
    unsigned char* out = NULL;
    unsigned long out_len = 0;
    jpeg_mem_dest(&cinfo, &out, &out_len);
    cinfo.image_width = bw * 8;
    cinfo.image_height = bh * 8;
    cinfo.input_components = 1;
    cinfo.in_color_space = JCS_GRAYSCALE;
    jpeg_set_defaults(&cinfo);
    cinfo.optimize_coding = TRUE;
    unsigned int table[64];
    const unsigned short* q = (const unsigned short*)in;
    for (int i = 0; i < 64; ++i) table[i] = q[i];
    /* jpeg_add_quant_table takes natural order */
    jpeg_add_quant_table(&cinfo, 0, table, 100, FALSE);
    jvirt_barray_ptr arrays[1];
    jpeg_component_info* comp = &cinfo.comp_info[0];
    comp->width_in_blocks = bw;
    comp->height_in_blocks = bh;
    arrays[0] = (*cinfo.mem->request_virt_barray)(
        (j_common_ptr)&cinfo, JPOOL_IMAGE, TRUE, bw, bh, 1);
    jpeg_write_coefficients(&cinfo, arrays);
    const short* c = (const short*)(in + 128);
    for (int by = 0; by < bh; ++by) {
        JBLOCKARRAY rows = (*cinfo.mem->access_virt_barray)(
            (j_common_ptr)&cinfo, arrays[0], by, 1, TRUE);
        memcpy(rows[0], c + (size_t)by * bw * 64, (size_t)bw * 128);
    }
    jpeg_finish_compress(&cinfo);
    fwrite(out, 1, out_len, stdout);
    jpeg_destroy_compress(&cinfo);
    return 0;
}

int main(int argc, char** argv) {
    if (argc >= 4 && !strcmp(argv[1], "coefwrite")) return coefwrite(argc, argv);
    if (argc >= 5 && !strcmp(argv[1], "encode")) return encode(argc, argv);
    if (argc >= 2 && !strcmp(argv[1], "decode")) return decode(argc, argv);
    fprintf(stderr, "usage: jpeg_writer encode|decode|coefwrite ...\n");
    return 2;
}
